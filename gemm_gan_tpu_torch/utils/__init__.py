"""Device choice, random streams, metrics and 2-D embeddings for the port
(counterpart of gemm_gan_tpu.utils); the package exports `key_seq` and
`split_like`, as JAX's does."""

from gemm_gan_tpu_torch.utils.prng import key_seq, split_like  # noqa: F401
