"""A Linear layer with the arithmetic of Flax's `nn.Dense(dtype=...)`.

Params stay f32 (`weight`, `bias`, as `nn.Linear`'s). The compute dtype
(`compute_dtype="bfloat16"` or "float32" in the config, `DTYPES`) decides
what the layer computes in:

* bf16: the input, weight and bias are cast to bf16, the product (f32
  accumulation) is rounded to bf16 and then the bias is added in bf16, as
  Flax's Dense does (`dot_general`, then `y + bias`, both in the compute
  dtype). That is two roundings where a fused `addmm` would take one; on
  the CPU the port then agrees with Flax bit for bit. Autograd carries the
  gradients back through the casts to the f32 params (and to an f32
  input), as JAX differentiates its `astype`.
* f32: the input is cast to f32 (a bf16 input reaches the f32 heads of the
  trunks), then one fused `addmm`.

`nn.Linear` itself rejects a bf16 input with f32 weights.

Under a mesh with a `model` axis (`parallel.sharding.shard_module_`) a
Linear may hold one rank's block of its parameters (`parallel`):

* "column": the rows of `weight` and `bias` (its outputs); each rank
  computes its outputs, which are all-gathered;
* "row": the columns of `weight` (its inputs); each rank multiplies its
  slice of the input, the partial products are all-reduced, then the
  (replicated) bias is added, in the compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Linear(nn.Linear):
    """`nn.Linear` (f32 params) computing in `dtype`."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.parallel = None  # ("column" | "row", mesh) on a model-sharded mesh

    def _dense(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        dtype = self.compute_dtype
        b = self.bias if bias else None
        if dtype == torch.float32:
            return F.linear(x.float(), self.weight, b)
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return y if b is None else y + b.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.parallel is None:
            return self._dense(x)
        from gemm_gan_tpu_torch.parallel import comm

        mode, mesh = self.parallel
        x = comm.copy_to(x, mesh)
        if mode == "column":
            return comm.gather(self._dense(x), mesh, dim=-1)
        k = self.weight.shape[1]
        x = x.narrow(-1, mesh.index("model") * k, k)
        y = comm.reduce_from(self._dense(x, bias=False), mesh)
        return y + self.bias.to(y.dtype)
