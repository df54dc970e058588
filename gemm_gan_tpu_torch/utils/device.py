"""Device choice for the port's entry points.

Counterpart of `gemm_gan_tpu/utils/backend.py`: where the JAX package probes
its accelerator backend, the port asks for the CUDA card. Every entry point
runs on CUDA unless its caller passes ``device="cpu"``; without a card and
without that argument it raises. There is no silent fall back to the CPU.
`as_f32` and `host` move an array or a tensor to where a computation runs
and back.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
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


def as_f32(x, device: DeviceLike = None) -> torch.Tensor:
    """`x` as a float32 tensor: a tensor stays on its device unless `device`
    names another; an array goes to `device` (`resolve_device`: the card
    unless "cpu")."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
