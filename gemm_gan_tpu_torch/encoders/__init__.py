"""Offline encoders: the UNI ViT and Clinical ModernBERT, the contrastive
projection pair, and the embedding caches that `data/tcga.py` reads.

Counterpart of `gemm_gan_tpu/encoders/`. The modules keep the published
checkpoints' parameter names (timm's for the ViT, HF's for ModernBERT), so
converted weights load with `load_state_dict(strict=True)`
(`cli/convert_encoders.py`). Their attention is plain PyTorch, as the JAX
encoders' is plain jnp: no kernel is involved.
"""
