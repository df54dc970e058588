"""Synthetic datasets (copies of gemm_gan_tpu.data.synthetic)."""
