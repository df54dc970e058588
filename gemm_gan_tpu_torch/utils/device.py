"""Device choice for the port's entry points.

Counterpart of `gemm_gan_tpu/utils/backend.py`: where the JAX package probes
its accelerator backend, the port asks for the CUDA card. Every entry point
runs on CUDA unless its caller passes ``device="cpu"``; without a card and
without that argument it raises. There is no silent fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA card, or raise when there is none.

    An explicit ``"cpu"`` (or ``"cuda[:i]"``) is taken as given; an explicit
    CUDA device without a card raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
