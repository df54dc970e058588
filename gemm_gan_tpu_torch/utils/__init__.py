"""Device choice for the port (counterpart of gemm_gan_tpu.utils)."""
