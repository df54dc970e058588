"""What every reference model shares: how a product takes its operands
(`Precision`, for the negative control) and how dropout draws its masks
(`Dropout`), so that the reference can follow a run of the program step by
step.

* `Dropout`: the masks, drawn from the default generator of the device in
  the order and with the dtype the program draws them, so that a seeded run
  of each side sees the same masks;
* `Precision`: every product's two operands rounded to a lower precision
  ("tf32": 10 mantissa bits; "fp8": float8_e4m3fn with one scale per
  tensor) before the product, for the negative control. The rounding is
  straight-through for autograd. None computes as the compute dtype says.
"""

from __future__ import annotations

from typing import Optional

import torch

FP8_MAX = 448.0


# ---------------------------------------------------------------- precision
def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 with its mantissa rounded to 10 bits (to nearest even)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8_e4m3fn with one scale per tensor (its largest magnitude maps
    to the format's largest finite value)."""
    x = x.float()
    scale = (x.abs().amax() / FP8_MAX).clamp_min(1e-30)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDINGS = {"tf32": _round_tf32, "fp8": _round_fp8}


class Precision:
    """How a product takes its operands: `op(x)` is x as given (None) or
    rounded by one of `ROUNDINGS`, with the identity's gradient."""

    def __init__(self, name: Optional[str] = None):
        if name is not None and name not in ROUNDINGS:
            raise ValueError(f"unknown precision {name!r}; known: {sorted(ROUNDINGS)}")
        self.name = name

    def op(self, x: torch.Tensor) -> torch.Tensor:
        if self.name is None:
            return x
        return x + (ROUNDINGS[self.name](x.detach()).to(x.dtype) - x).detach()


# ------------------------------------------------------------------ dropout
def dropout_mask(shape, dtype: torch.dtype, p: float, device) -> torch.Tensor:
    """The keep-mask (float, 0 or 1) that PyTorch's dropout draws for a
    contiguous tensor of `shape` and `dtype` on `device`, from the default
    generator of that device: on CUDA the fused kernel's mask
    (`native_dropout`), elsewhere `bernoulli_(1 - p)` on a tensor like the
    input, as `torch.nn.functional.dropout` draws them."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.native_dropout(torch.empty(shape, dtype=dtype, device=device),
                                    p, True)[1].float()
    return torch.empty(shape, dtype=dtype, device=device).bernoulli_(1 - p).float()


class Dropout:
    """Dropout at rate `p` whose masks are drawn as the program draws them:
    with the program's compute dtype `dtype` (the dtype of the tensors it
    drops)."""

    def __init__(self, p: float, dtype: torch.dtype):
        self.p, self.dtype = p, dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x * mask / (1 - p), taken in f32 and stored in x's dtype."""
        if self.p == 0:
            return x
        mask = dropout_mask(x.shape, self.dtype, self.p, x.device)
        return (x.float() * mask * (1.0 / (1 - self.p))).to(x.dtype)

    def skip(self, shape, device) -> None:
        """Draw (and drop) the mask of a tensor of `shape`, as a call would."""
        if self.p > 0:
            dropout_mask(shape, self.dtype, self.p, device)
