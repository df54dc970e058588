"""gemm_gan_tpu_torch — the PyTorch / CUDA port of gemm_gan_tpu.

Serves the flagship `film_cross_attention` generator on an NVIDIA H100
(`serving.GeneratorServer`) and trains it with the fused WGAN-GP step
(`train.wgan.WGANGPEngine`), whole epochs from a device-resident
`data.device_cache.DeviceCache` as replays of one CUDA graph, in f32 or in
the JAX package's bench configuration (`compute_dtype="bfloat16"`). Its
attention runs through hand-written CUDA
flash-attention kernels, forward and backward (`kernels/csrc/`), each with
a plain PyTorch version that the CPU path takes. The JAX package `gemm_gan_tpu` stays the reference; this
package imports nothing of it and no JAX.

Entry points run on the CUDA card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from gemm_gan_tpu_torch.config import (  # noqa: F401
    ExperimentConfig,
    FusionConfig,
    ModelConfig,
    load_config,
    variant_config,
)
