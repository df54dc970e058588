"""Masked multi-head attention: hand-written CUDA kernels + plain PyTorch.

Counterpart of `gemm_gan_tpu/kernels/flash_attention.py`. Masks are boolean
with **True = valid**; rows with no valid key return 0 (torch's own
attention would return NaN).

Two forward kernels, one CUDA template on the tensor cores in 3xTF32
(f32-grade), `csrc/flash_fwd.cuh` (entry points in `flash_fwd.cu`):

* `flash_fwd_ble` (replaces the TPU's `_fwd_kernel_ble`): q, k, v in the
  raw projection layout [B, L, E = H*D], heads split by column offset inside
  the kernel. `masked_mha(layout="ble")` takes it for
  MIN_PALLAS_LQ <= Lq <= BLE_MAX_L and Lk <= BLE_MAX_L (the canonical
  257-token patch self-attention).
* `flash_fwd_bhld` (replaces the TPU's blocked `_fwd_kernel`): q, k, v as
  [B, H, L, D], for longer sequences (whole-slide patch counts).

Each has a **plain PyTorch version** (`*_plain`) with the same arithmetic
contract, returning `(o, lse)` with lse [B, H, Lq] f32. A kernel wrapper
runs the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises. Each wrapper counts its launches in a plain
int attribute (`flash_fwd_ble.launches`, `flash_fwd_bhld.launches`), so a
run can show that its path went through the kernels.

Four backward kernels on the tensor cores in 3xTF32, each with a plain
version and a launch counter of its own; all four run the dq and dk/dv
tiles of `csrc/flash_bwd_tc.cuh` (their bf16-ref modes, below, the
warpgroup-MMA tiles of `csrc/flash_bwd_wg.cuh`):

* `flash_bwd_ble` (replaces `_bwd_kernel_ble`) and `flash_bwd_bhld_fused`
  (replaces `_bwd_fused_kernel`): dq, dk, dv in one launch, the two layouts
  of one CUDA template, `csrc/flash_bwd_fused.cuh`. The ble one computes
  delta = rowsum(dO * O) in the kernel; the classic one is for
  single-block shapes (`single_block`).
* `flash_bwd_dq` and `flash_bwd_dkv` (replace `_bwd_dq_kernel` and
  `_bwd_dkv_kernel`): the blocked classic backward, two launches;
  `csrc/flash_bwd_dq.cuh` and `csrc/flash_bwd_dkv.cuh`.

Every kernel also takes bf16, in two product modes of its own (the same
templates, `csrc/flash_ops.cuh`), each with its own C entry point, wrapper
and launch counter (the JAX package's bf16 configuration,
`compute_dtype="bfloat16"` and `fusion.flash_mxu_bf16`):

* `<kernel>_bf16` (`flash_fwd_ble_bf16`, ..., `flash_bwd_dkv_bf16`): bf16
  q, k, v (and o, dO), every product f32-exact (a bf16 operand is exact in
  bf16; an f32 one, P or dS, is split into three bf16 terms), softmax,
  lse, delta and accumulators in f32, outputs rounded once to bf16;
* `<kernel>_mxu` (`mxu_bf16`): every product's operands, P and dS
  included, rounded to bf16 (to nearest even) with f32 accumulation; q, k,
  v, dO in f32 (rounded on load, f32 outputs) or bf16. The classic
  forward rounds P per key block as JAX's blocked kernel does
  (`classic_block_k`).

Their plain versions are the f32 ones with bf16 operands or
`mxu_bf16=True`; `FlashAttentionBLE` and `FlashAttentionBHLD` pick the
wrappers by the operands' dtype and the mode. On bf16 operands (bf16 refs)
every kernel runs a warpgroup-MMA (`wgmma`) tile at head dims 16, 32 and
64: the forward's `csrc/flash_fwd_wg.cuh` in either layout, the backward's
`csrc/flash_bwd_wg.cuh`.

`flash_mha_ble` and `flash_mha` run through a `torch.autograd.Function`
per layout (`FlashAttentionBLE`, `FlashAttentionBHLD`) whose backward is
one of these kernels, dispatched as the JAX package's custom VJPs do. The
softmax scale is folded into q outside the Function, so autograd applies
it to dq. First order only (`once_differentiable`): the training engine
never differentiates attention twice. Called directly, a forward wrapper
raises for inputs that require grad while grad mode is on, since its
output would silently drop the gradient. The `use_pallas` name is kept
from the JAX config so `config.json` files load; here it selects the
kernels.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from gemm_gan_tpu_torch.kernels import build

_NEG_INF = -1e30
MIN_PALLAS_LQ = 128   # below this the plain reference serves (CLS queries)
BLE_MAX_L = 512       # the ble kernel serves single-block shapes up to this
# sequences at least this long take the blocked reference when the kernels
# are off, so the [Lq, Lk] logits are never materialized whole
BLOCKED_REF_MIN_LK = 2048
_REF_BLOCK_Q = 128    # query rows per block of `mha_reference_blocked`
_PLAIN_BLOCK_Q = 512  # query rows per chunk of the plain classic version
HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernels' template instantiations
# the JAX package's classic blocking (`flash_mha` defaults): a shape is one
# block, and takes the fused backward, when both padded lengths fit these;
# longer key axes are cut into blocks of BLOCK_K keys
SINGLE_BLOCK_Q = 512
SINGLE_BLOCK_K = 512
BLOCK_K = 256


def mha_reference(q, k, v, kv_mask=None, scale=None):
    """softmax(QK^T * scale + mask)V in plain PyTorch.

    q: [B, H, Lq, D]; k, v: [B, H, Lk, D]; kv_mask: [B, Lk] bool True=valid.
    Fully-masked query rows return 0. Both products take f32 accumulation;
    the weights are cast to v's dtype and the output to q's, as the JAX
    reference does (bf16 operands under `compute_dtype="bfloat16"`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        valid = kv_mask[:, None, None, :]
        logits = torch.where(valid, logits, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits - m)
    if kv_mask is not None:
        unnorm = torch.where(valid, unnorm, 0.0)
    denom = unnorm.sum(dim=-1, keepdim=True)
    weights = unnorm / denom.clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def mha_reference_blocked(q, k, v, kv_mask=None, scale=None):
    """`mha_reference` one block of query rows at a time: the peak extra
    memory is one [B, H, _REF_BLOCK_Q, Lk] block instead of the whole
    logits matrix. Under autograd each block is recomputed in the backward
    (`torch.utils.checkpoint`, as the JAX package's `jax.checkpoint` per
    block), so the saved activations stay O(block) too."""
    return torch.cat([checkpoint(mha_reference, q[:, :, s:s + _REF_BLOCK_Q], k, v, kv_mask,
                                 scale, use_reentrant=False, preserve_rng_state=False)
                      for s in range(0, q.shape[2], _REF_BLOCK_Q)], dim=2)


# ------------------------------------------------------------ plain versions
# Each takes q, k, v (and dO, o) in f32 or bf16 and computes in f32 from
# their values: softmax, lse and sums in f32, outputs cast once to the
# operands' dtype, lse [.., Lq] f32. `mxu_bf16` rounds every product's
# operands to bf16 (to nearest even, as the JAX package's `_mxu_in`): q, k,
# v, dO, and P and dS before their products.
def _operand(x, mxu_bf16: bool):
    """`x` as a product takes it: rounded to bf16 under `mxu_bf16`, in f32."""
    return (x.to(torch.bfloat16) if mxu_bf16 else x).float()


def _softmax_fwd(q, k, v, valid, mxu_bf16: bool = False, block_k: int = None):
    """The kernels' contract on pre-scaled q [..., Lq, D], k/v [..., Lk, D],
    `valid` broadcastable to the logits: returns (o in q's dtype, lse
    [..., Lq] f32).

    Where P is rounded (`mxu_bf16`) the rounded value depends on the key
    blocks, and this follows the JAX kernels': with one block (`block_k`
    None or >= Lk, the ble kernel and single-block classic shapes) P is
    exp(s - the row's max over all its keys); with blocks of `block_k`
    keys from key 0 (the blocked `_fwd_kernel`) each block rounds exp(s -
    m), m the running max up to the block's end, and the sums taken so far
    are rescaled by exp(m_prev - m). Without rounding the blocks change
    only the summation order, so the sums are taken whole."""
    dtype = q.dtype
    q, k, v = (_operand(x, mxu_bf16) for x in (q, k, v))
    s = torch.where(valid, q @ k.transpose(-1, -2), _NEG_INF)
    Lk = s.shape[-1]
    if not mxu_bf16 or block_k is None or block_k >= Lk:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)  # masked columns: exp(-1e30 - m) == 0 unless all are
        l = p.sum(dim=-1, keepdim=True)
        acc = _operand(p, mxu_bf16) @ v
    else:
        m = torch.full_like(s[..., :1], _NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((*s.shape[:-1], v.shape[-1]), dtype=s.dtype, device=s.device)
        for k0 in range(0, Lk, block_k):
            sb = s[..., k0:k0 + block_k]
            m_new = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
            p = torch.exp(sb - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + _operand(p, True) @ v[..., k0:k0 + block_k, :]
            m = m_new
    l = l.clamp_min(1e-30)
    o = torch.where(m <= 0.5 * _NEG_INF, 0.0, acc / l)
    return o.to(dtype), (m + torch.log(l)).squeeze(-1)


def classic_block_k(Lk: int) -> int:
    """Keys per block of the JAX package's classic forward (`_prep` with
    block_k BLOCK_K): all of them when Lk padded to 128 fits
    SINGLE_BLOCK_K, else BLOCK_K."""
    return Lk if -(-Lk // 128) * 128 <= SINGLE_BLOCK_K else BLOCK_K


def _split_heads(x, num_heads: int):
    """[B, L, H*D] -> [B, H, L, D] (a view)."""
    B, L, E = x.shape
    return x.reshape(B, L, num_heads, E // num_heads).transpose(1, 2)


def _merge_heads(x):
    """[B, H, L, D] -> [B, L, H*D]."""
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D)


def flash_fwd_ble_plain(q, k, v, kv_mask, num_heads: int, mxu_bf16: bool = False):
    """Plain version of `flash_fwd_ble` (f32), `flash_fwd_ble_bf16` (bf16
    operands) and `flash_fwd_ble_mxu` (`mxu_bf16`): q [B, Lq, E], k/v
    [B, Lk, E] (q already scaled), kv_mask [B, Lk] -> (o [B, Lq, E], lse
    [B, H, Lq])."""
    o, lse = _softmax_fwd(*(_split_heads(x, num_heads) for x in (q, k, v)),
                          kv_mask[:, None, None, :], mxu_bf16)
    return _merge_heads(o), lse


def flash_fwd_ble_mxu_plain(q, k, v, kv_mask, num_heads: int):
    """Plain version of `flash_fwd_ble_mxu`."""
    return flash_fwd_ble_plain(q, k, v, kv_mask, num_heads, mxu_bf16=True)


def flash_fwd_bhld_plain(q, k, v, kv_mask, mxu_bf16: bool = False):
    """Plain version of `flash_fwd_bhld` (f32), `flash_fwd_bhld_bf16` (bf16
    operands) and `flash_fwd_bhld_mxu` (`mxu_bf16`, P rounded per key block
    of `classic_block_k`): q [B, H, Lq, D], k/v [B, H, Lk, D] (q already
    scaled) -> (o [B, H, Lq, D], lse [B, H, Lq]). Runs in chunks of query
    rows so whole-slide lengths never hold the full logits."""
    valid = kv_mask[:, None, None, :]
    block_k = classic_block_k(k.shape[2])
    parts = [_softmax_fwd(q[:, :, s:s + _PLAIN_BLOCK_Q], k, v, valid, mxu_bf16, block_k)
             for s in range(0, q.shape[2], _PLAIN_BLOCK_Q)]
    return (torch.cat([p[0] for p in parts], dim=2),
            torch.cat([p[1] for p in parts], dim=2))


def _bwd_probs(q, k, valid, lse):
    """p = exp(s - lse) over the valid keys, exactly 0 elsewhere."""
    s = torch.where(valid, q @ k.transpose(-1, -2), _NEG_INF)
    return torch.where(valid, torch.exp(s - lse[..., None]), 0.0)


def flash_bwd_dq_plain(q, k, v, kv_mask, do, lse, delta, mxu_bf16: bool = False):
    """Plain version of `flash_bwd_dq`: q/do [B, H, Lq, D], k/v
    [B, H, Lk, D], lse/delta [B, H, Lq] -> dq [B, H, Lq, D], in chunks of
    query rows."""
    valid = kv_mask[:, None, None, :]
    qf, kf, vf, dof = (_operand(x, mxu_bf16) for x in (q, k, v, do))
    parts = []
    for s in range(0, q.shape[2], _PLAIN_BLOCK_Q):
        rows = slice(s, s + _PLAIN_BLOCK_Q)
        p = _bwd_probs(qf[:, :, rows], kf, valid, lse[:, :, rows])
        ds = p * (dof[:, :, rows] @ vf.transpose(-1, -2) - delta[:, :, rows, None])
        parts.append(_operand(ds, mxu_bf16) @ kf)
    return torch.cat(parts, dim=2).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, kv_mask, do, lse, delta, mxu_bf16: bool = False):
    """Plain version of `flash_bwd_dkv`: same inputs as `flash_bwd_dq_plain`
    -> (dk, dv) [B, H, Lk, D], summed over chunks of query rows."""
    valid = kv_mask[:, None, None, :]
    qf, kf, vf, dof = (_operand(x, mxu_bf16) for x in (q, k, v, do))
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for s in range(0, q.shape[2], _PLAIN_BLOCK_Q):
        rows = slice(s, s + _PLAIN_BLOCK_Q)
        qc, doc = qf[:, :, rows], dof[:, :, rows]
        p = _bwd_probs(qc, kf, valid, lse[:, :, rows])
        ds = p * (doc @ vf.transpose(-1, -2) - delta[:, :, rows, None])
        dv += _operand(p, mxu_bf16).transpose(-1, -2) @ doc
        dk += _operand(ds, mxu_bf16).transpose(-1, -2) @ qc
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_bhld_fused_plain(q, k, v, kv_mask, do, lse, delta, mxu_bf16: bool = False):
    """Plain version of `flash_bwd_bhld_fused` -> (dq, dk, dv)."""
    return (flash_bwd_dq_plain(q, k, v, kv_mask, do, lse, delta, mxu_bf16),
            *flash_bwd_dkv_plain(q, k, v, kv_mask, do, lse, delta, mxu_bf16))


def flash_bwd_ble_plain(q, k, v, kv_mask, o, lse, do, num_heads: int,
                        mxu_bf16: bool = False):
    """Plain version of `flash_bwd_ble` (f32), `flash_bwd_ble_bf16` (bf16
    operands) and `flash_bwd_ble_mxu` (`mxu_bf16`): q/o/do [B, Lq, E], k/v
    [B, Lk, E], lse [B, H, Lq] -> (dq, dk, dv) in the same layout; delta
    from the stored o and dO in f32 (dO unrounded, as the Pallas kernel)."""
    q, k, v, o, do = (_split_heads(x, num_heads) for x in (q, k, v, o, do))
    delta = (do.float() * o.float()).sum(-1)
    grads = flash_bwd_bhld_fused_plain(q, k, v, kv_mask, do, lse, delta, mxu_bf16)
    return tuple(_merge_heads(g) for g in grads)


def flash_bwd_ble_mxu_plain(q, k, v, kv_mask, o, lse, do, num_heads: int):
    """Plain version of `flash_bwd_ble_mxu`."""
    return flash_bwd_ble_plain(q, k, v, kv_mask, o, lse, do, num_heads, mxu_bf16=True)


def flash_fwd_bhld_mxu_plain(q, k, v, kv_mask):
    """Plain version of `flash_fwd_bhld_mxu`."""
    return flash_fwd_bhld_plain(q, k, v, kv_mask, mxu_bf16=True)


def flash_bwd_bhld_fused_mxu_plain(q, k, v, kv_mask, do, lse, delta):
    """Plain version of `flash_bwd_bhld_fused_mxu`."""
    return flash_bwd_bhld_fused_plain(q, k, v, kv_mask, do, lse, delta, mxu_bf16=True)


def flash_bwd_dq_mxu_plain(q, k, v, kv_mask, do, lse, delta):
    """Plain version of `flash_bwd_dq_mxu`."""
    return flash_bwd_dq_plain(q, k, v, kv_mask, do, lse, delta, mxu_bf16=True)


def flash_bwd_dkv_mxu_plain(q, k, v, kv_mask, do, lse, delta):
    """Plain version of `flash_bwd_dkv_mxu`."""
    return flash_bwd_dkv_plain(q, k, v, kv_mask, do, lse, delta, mxu_bf16=True)


# bf16 operands, f32 products: the plain versions as they are
flash_fwd_ble_bf16_plain = flash_fwd_ble_plain
flash_bwd_ble_bf16_plain = flash_bwd_ble_plain
flash_fwd_bhld_bf16_plain = flash_fwd_bhld_plain
flash_bwd_bhld_fused_bf16_plain = flash_bwd_bhld_fused_plain
flash_bwd_dq_bf16_plain = flash_bwd_dq_plain
flash_bwd_dkv_bf16_plain = flash_bwd_dkv_plain


# ------------------------------------------------------------ kernel wrappers
# Each kernel comes in three modes, each with its own C entry point, wrapper
# and launch counter: f32 (no suffix); `_bf16`, bf16 operands with f32-exact
# products; `_mxu`, every product's operands rounded to bf16 (P and dS too)
# on f32 or bf16 operands, whose entry points take one more int, 1 for bf16
# refs. lse and delta are f32 in every mode; dO and o come in the operands'
# dtype.
_MODE_DTYPES = {"": (torch.float32,), "_bf16": (torch.bfloat16,),
                "_mxu": (torch.float32, torch.bfloat16)}


def _mode(name: str) -> str:
    """The mode of entry point `name`: "", "_bf16" or "_mxu"."""
    return next((m for m in ("_bf16", "_mxu") if name.endswith(m)), "")


def _mode_args(name: str, q) -> tuple:
    """The int arguments after the stream: bf16_refs for an `_mxu` entry."""
    return (int(q.dtype == torch.bfloat16),) if _mode(name) == "_mxu" else ()


def _check_inputs(name, q, k, v, kv_mask, kv_shape, head_dim):
    """Raise on anything entry point `name` does not take. q's own shape
    defines B, Lq and the width; k and v must have `kv_shape`, whose first
    and second-to-last entries are B and Lk in both layouts, and q's dtype,
    one that `name`'s mode takes."""
    dtypes = _MODE_DTYPES[_mode(name)]
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {n} is on {t.device}; the kernel takes "
                             f"CUDA tensors on one device")
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise NotImplementedError(f"{name}: {n} is {t.dtype} (q {q.dtype}); "
                                      f"the kernel takes {dtypes}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be contiguous and 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: {n} requires grad, and the kernel's output would drop "
                f"it; call flash_mha / flash_mha_ble, whose autograd.Function "
                f"runs the backward kernel")
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"must both be {kv_shape} for q {tuple(q.shape)}")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"{name}: empty input q {tuple(q.shape)}, k {tuple(k.shape)}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {head_dim} not in {HEAD_DIMS}")
    mask_shape = (kv_shape[0], kv_shape[-2])
    if (kv_mask.dtype != torch.bool or kv_mask.device != q.device
            or not kv_mask.is_contiguous() or tuple(kv_mask.shape) != mask_shape):
        raise ValueError(f"{name}: kv_mask must be a contiguous bool "
                         f"{mask_shape} tensor on {q.device}")


def _launch_fwd_ble(name, q, k, v, kv_mask, num_heads):
    """Check, allocate and launch C entry point `name` of the ble forward."""
    B, Lq, E = q.shape
    Lk = k.shape[1]
    if E % num_heads:
        raise ValueError(f"E={E} not divisible by num_heads={num_heads}")
    D = E // num_heads
    _check_inputs(name, q, k, v, kv_mask, (B, Lk, E), D)
    o = torch.empty_like(q)
    lse = torch.empty((B, num_heads, Lq), dtype=torch.float32, device=q.device)
    build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 B, Lq, Lk, num_heads, D,
                 torch.cuda.current_stream(q.device).cuda_stream, *_mode_args(name, q))
    return o, lse


def _check_grad_inputs(name, q, named):
    """Raise on anything a backward kernel does not take, beyond what
    `_check_inputs` checks: `named` maps each extra operand's name to
    (tensor, shape) or (tensor, shape, dtype); the dtype defaults to f32."""
    for n, (t, shape, *dtype) in named.items():
        dtype = dtype[0] if dtype else torch.float32
        if (t.device != q.device or t.dtype != dtype or not t.is_contiguous()
                or t.data_ptr() % 16 or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{name}: {n} must be a contiguous, 16-byte aligned "
                             f"{dtype} {tuple(shape)} tensor on {q.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_bwd(name, q, k, v, kv_mask, o, do, lse, delta, dq, dk, dv,
                B, Lq, Lk, H, D, *extra):
    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch(name, *(ptr(t) for t in (q, k, v, kv_mask, o, do, lse, delta,
                                          dq, dk, dv)),
                 B, Lq, Lk, H, D, torch.cuda.current_stream(q.device).cuda_stream, *extra)


def _launch_bwd_ble(name, q, k, v, kv_mask, o, lse, do, num_heads):
    """Check, allocate and launch C entry point `name` of the ble backward."""
    B, Lq, E = q.shape
    Lk = k.shape[1]
    D = E // num_heads
    _check_inputs(name, q, k, v, kv_mask, (B, Lk, E), D)
    _check_grad_inputs(name, q, {
        "o": (o, q.shape, q.dtype), "do": (do, q.shape, q.dtype),
        "lse": (lse, (B, num_heads, Lq), torch.float32)})
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_bwd(name, q, k, v, kv_mask, o, do, lse, None, dq, dk, dv,
                B, Lq, Lk, num_heads, D, *_mode_args(name, q))
    return dq, dk, dv


def _launch_bhld(name, q, k, v, kv_mask, *grad_args):
    """Check, allocate and launch C entry point `name` of a classic-layout
    kernel on q [B, H, Lq, D], k/v [B, H, Lk, D]: the forward -> (o, lse);
    given (do, lse, delta), a backward -> what its entry point writes: dq,
    (dk, dv) or (dq, dk, dv)."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    _check_inputs(name, q, k, v, kv_mask, (B, H, Lk, D), D)
    if not grad_args:
        o = torch.empty_like(q)
        lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
        build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), B, Lq, Lk, H, D,
                     torch.cuda.current_stream(q.device).cuda_stream, *_mode_args(name, q))
        return o, lse
    do, lse, delta = grad_args
    _check_grad_inputs(name, q, {
        "do": (do, q.shape, q.dtype), "lse": (lse, (B, H, Lq), torch.float32),
        "delta": (delta, (B, H, Lq), torch.float32)})
    dq = None if name.startswith("flash_bwd_dkv") else torch.empty_like(q)
    dk, dv = ((None, None) if name.startswith("flash_bwd_dq")
              else (torch.empty_like(k), torch.empty_like(v)))
    _launch_bwd(name, q, k, v, kv_mask, None, do, lse, delta, dq, dk, dv,
                B, Lq, Lk, H, D, *_mode_args(name, q))
    if dq is None:
        return dk, dv
    return dq if dk is None else (dq, dk, dv)


def _kernel(name: str, plain, launch, doc: str):
    """The wrapper of C entry point `name`: `plain(*args)` for tensors on
    the CPU, else `launch(name, *args)`, counted in its `launches`."""
    def kernel(*args):
        if args[0].device.type == "cpu":
            return plain(*args)
        out = launch(name, *args)
        kernel.launches += 1
        return out

    kernel.__name__ = kernel.__qualname__ = name
    kernel.__doc__ = doc
    kernel.launches = 0
    return kernel


flash_fwd_ble = _kernel("flash_fwd_ble", flash_fwd_ble_plain, _launch_fwd_ble, """Kernel
    `flash_fwd_ble`: (q, k, v, kv_mask, num_heads), pre-scaled f32 q [B, Lq,
    E], k/v [B, Lk, E], kv_mask [B, Lk] bool -> (o [B, Lq, E], lse [B, H, Lq]
    f32).""")
flash_fwd_ble_bf16 = _kernel("flash_fwd_ble_bf16", flash_fwd_ble_plain, _launch_fwd_ble, """
    Kernel `flash_fwd_ble_bf16`: `flash_fwd_ble` on bf16 q, k, v with
    f32-exact products -> (o bf16, lse f32).""")
flash_fwd_ble_mxu = _kernel("flash_fwd_ble_mxu", flash_fwd_ble_mxu_plain, _launch_fwd_ble, """
    Kernel `flash_fwd_ble_mxu`: `flash_fwd_ble` with every product's operands
    (P too) rounded to bf16; q, k, v f32 or bf16, o in their dtype, lse f32.""")
flash_bwd_ble = _kernel("flash_bwd_ble", flash_bwd_ble_plain, _launch_bwd_ble, """Kernel
    `flash_bwd_ble`: (q, k, v, kv_mask, o, lse, do, num_heads), the
    forward's f32 inputs (q pre-scaled), its outputs o [B, Lq, E] and lse
    [B, H, Lq], and dO [B, Lq, E] -> (dq, dk, dv) in the [B, L, E] layout.""")
flash_bwd_ble_bf16 = _kernel("flash_bwd_ble_bf16", flash_bwd_ble_plain, _launch_bwd_ble, """
    Kernel `flash_bwd_ble_bf16`: `flash_bwd_ble` on bf16 q, k, v, o, dO with
    f32-exact products -> bf16 (dq, dk, dv).""")
flash_bwd_ble_mxu = _kernel("flash_bwd_ble_mxu", flash_bwd_ble_mxu_plain, _launch_bwd_ble, """
    Kernel `flash_bwd_ble_mxu`: `flash_bwd_ble` with every product's operands
    (P and dS too) rounded to bf16; q, k, v, o, dO f32 or bf16, dq, dk, dv in
    their dtype.""")
flash_fwd_bhld = _kernel("flash_fwd_bhld", flash_fwd_bhld_plain, _launch_bhld, """Kernel
    `flash_fwd_bhld`: (q, k, v, kv_mask), pre-scaled f32 q [B, H, Lq, D], k/v
    [B, H, Lk, D], kv_mask [B, Lk] bool -> (o [B, H, Lq, D], lse [B, H, Lq]
    f32).""")
flash_fwd_bhld_bf16 = _kernel("flash_fwd_bhld_bf16", flash_fwd_bhld_plain, _launch_bhld, """
    Kernel `flash_fwd_bhld_bf16`: `flash_fwd_bhld` on bf16 q, k, v with
    f32-exact products -> (o bf16, lse f32).""")
flash_fwd_bhld_mxu = _kernel("flash_fwd_bhld_mxu", flash_fwd_bhld_mxu_plain, _launch_bhld, """
    Kernel `flash_fwd_bhld_mxu`: `flash_fwd_bhld` with every product's
    operands rounded to bf16, P per key block of `classic_block_k` as JAX's
    blocked kernel rounds it; q, k, v f32 or bf16, o in their dtype.""")
flash_bwd_bhld_fused = _kernel(
    "flash_bwd_bhld_fused", flash_bwd_bhld_fused_plain, _launch_bhld, """Kernel
    `flash_bwd_bhld_fused`: (q, k, v, kv_mask, do, lse, delta), f32 q/do [B,
    H, Lq, D], k/v [B, H, Lk, D], lse and delta = rowsum(dO * O) [B, H, Lq]
    f32 -> (dq, dk, dv), one launch. Meant for single-block shapes
    (`single_block`), as on the TPU; right for any shape.""")
flash_bwd_bhld_fused_bf16 = _kernel(
    "flash_bwd_bhld_fused_bf16", flash_bwd_bhld_fused_plain, _launch_bhld, """Kernel
    `flash_bwd_bhld_fused_bf16`: `flash_bwd_bhld_fused` on bf16 q, k, v, dO
    with f32-exact products -> bf16 (dq, dk, dv).""")
flash_bwd_bhld_fused_mxu = _kernel(
    "flash_bwd_bhld_fused_mxu", flash_bwd_bhld_fused_mxu_plain, _launch_bhld, """Kernel
    `flash_bwd_bhld_fused_mxu`: `flash_bwd_bhld_fused` with every product's
    operands (P and dS too) rounded to bf16; q, k, v, dO f32 or bf16, the
    gradients in their dtype.""")
flash_bwd_dq = _kernel("flash_bwd_dq", flash_bwd_dq_plain, _launch_bhld, """Kernel
    `flash_bwd_dq`: inputs as `flash_bwd_bhld_fused` -> dq.""")
flash_bwd_dq_bf16 = _kernel("flash_bwd_dq_bf16", flash_bwd_dq_plain, _launch_bhld, """Kernel
    `flash_bwd_dq_bf16`: `flash_bwd_dq` on bf16 operands, f32-exact products.""")
flash_bwd_dq_mxu = _kernel("flash_bwd_dq_mxu", flash_bwd_dq_mxu_plain, _launch_bhld, """Kernel
    `flash_bwd_dq_mxu`: `flash_bwd_dq` with every product's operands rounded
    to bf16.""")
flash_bwd_dkv = _kernel("flash_bwd_dkv", flash_bwd_dkv_plain, _launch_bhld, """Kernel
    `flash_bwd_dkv`: inputs as `flash_bwd_bhld_fused` -> (dk, dv).""")
flash_bwd_dkv_bf16 = _kernel("flash_bwd_dkv_bf16", flash_bwd_dkv_plain, _launch_bhld, """
    Kernel `flash_bwd_dkv_bf16`: `flash_bwd_dkv` on bf16 operands, f32-exact
    products.""")
flash_bwd_dkv_mxu = _kernel("flash_bwd_dkv_mxu", flash_bwd_dkv_mxu_plain, _launch_bhld, """
    Kernel `flash_bwd_dkv_mxu`: `flash_bwd_dkv` with every product's operands
    rounded to bf16.""")

KERNELS = (flash_fwd_ble, flash_fwd_bhld, flash_bwd_ble, flash_bwd_bhld_fused,
           flash_bwd_dq, flash_bwd_dkv, flash_fwd_ble_bf16, flash_fwd_ble_mxu,
           flash_bwd_ble_bf16, flash_bwd_ble_mxu,
           flash_fwd_bhld_bf16, flash_fwd_bhld_mxu, flash_bwd_bhld_fused_bf16,
           flash_bwd_bhld_fused_mxu, flash_bwd_dq_bf16, flash_bwd_dq_mxu,
           flash_bwd_dkv_bf16, flash_bwd_dkv_mxu)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last `reset_launch_counts`}, those
    made by replays of CUDA graphs included (see `recorded_launches`)."""
    return {kernel.__name__: kernel.launches for kernel in KERNELS}


@contextlib.contextmanager
def recorded_launches():
    """For a CUDA graph's capture: within the block the wrappers record
    their kernels into the graph and launch nothing, so the block's counts
    are taken back off the counters on exit and left in the yielded dict
    ({kernel name: launches one replay makes}), for `count_replays`."""
    before = launch_counts()
    recorded = {}
    try:
        yield recorded
    finally:
        for kernel in KERNELS:
            n = kernel.launches - before[kernel.__name__]
            kernel.launches -= n
            if n:
                recorded[kernel.__name__] = n


def count_replays(recorded: dict, replays: int) -> None:
    """Add `replays` replays of a graph whose capture recorded `recorded`
    (from `recorded_launches`) to the counters: each replay launches every
    recorded kernel again."""
    for kernel in KERNELS:
        kernel.launches += replays * recorded.get(kernel.__name__, 0)


def single_block(Lq: int, Lk: int) -> bool:
    """Whether the JAX package's blocking (`_prep` with block_q 512,
    block_k 256) makes one block of each axis: Lq padded to 8 and Lk padded
    to 128 both fit 512. Such shapes take the fused backward."""
    return -(-Lq // 8) * 8 <= SINGLE_BLOCK_Q and -(-Lk // 128) * 128 <= SINGLE_BLOCK_K


def _wrappers(names, dtype, mxu_bf16: bool) -> tuple:
    """The wrappers of kernels `names` in the mode that the operands' dtype
    and `mxu_bf16` select, looked up when called."""
    mode = "_mxu" if mxu_bf16 else "_bf16" if dtype == torch.bfloat16 else ""
    return tuple(globals()[name + mode] for name in names)


def _ble_kernels(dtype, mxu_bf16: bool):
    """The (forward, backward) wrappers of the ble pair."""
    return _wrappers(("flash_fwd_ble", "flash_bwd_ble"), dtype, mxu_bf16)


def _bhld_kernels(dtype, mxu_bf16: bool):
    """The (forward, fused backward, dq, dk/dv) wrappers of the classic
    layout."""
    return _wrappers(("flash_fwd_bhld", "flash_bwd_bhld_fused", "flash_bwd_dq",
                      "flash_bwd_dkv"), dtype, mxu_bf16)


class FlashAttentionBLE(torch.autograd.Function):
    """o = flash_fwd_ble(q, k, v) with `flash_bwd_ble` as its backward, or
    the bf16 / `mxu_bf16` pair of the same two kernels (`_ble_kernels`);
    the gradients come in the operands' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, num_heads, mxu_bf16=False):
        fwd, _ = _ble_kernels(q.dtype, mxu_bf16)
        o, lse = fwd(q, k, v, kv_mask, num_heads)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.num_heads, ctx.mxu_bf16 = num_heads, mxu_bf16
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        _, bwd = _ble_kernels(q.dtype, ctx.mxu_bf16)
        dq, dk, dv = bwd(q, k, v, kv_mask, o, lse, do.contiguous(), ctx.num_heads)
        return dq, dk, dv, None, None, None


class FlashAttentionBHLD(torch.autograd.Function):
    """o = flash_fwd_bhld(q, k, v) with the JAX package's backward dispatch:
    `flash_bwd_bhld_fused` for single-block shapes, else `flash_bwd_dq` and
    `flash_bwd_dkv`; or the bf16 / `mxu_bf16` modes of the same kernels
    (`_bhld_kernels`). delta = rowsum(dO * O) in f32 (from the f32 upcast of
    dO and O) is a plain tensor op here, as on the TPU."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, mxu_bf16=False):
        o, lse = _bhld_kernels(q.dtype, mxu_bf16)[0](q, k, v, kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.mxu_bf16 = mxu_bf16
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        _, fused, dq_kernel, dkv_kernel = _bhld_kernels(q.dtype, ctx.mxu_bf16)
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, kv_mask, do, lse, delta)
        if single_block(q.shape[2], k.shape[2]):
            dq, dk, dv = fused(*args)
        else:
            dq = dq_kernel(*args)
            dk, dv = dkv_kernel(*args)
        return dq, dk, dv, None, None


def _full_mask(kv_mask, B, Lk, device):
    if kv_mask is None:
        return torch.ones((B, Lk), dtype=torch.bool, device=device)
    return kv_mask.contiguous()


def _scale_q(q, scale: float):
    """q * scale with the scale rounded to q's dtype first, as the JAX
    package folds it (`q * jnp.asarray(scale, q.dtype)`); a host float, so
    a CUDA graph can capture the multiply."""
    return q * float(torch.tensor(scale, dtype=q.dtype))


def flash_mha_ble(q, k, v, kv_mask=None, scale=None, num_heads: int = 4,
                  mxu_bf16: bool = False):
    """E-layout flash attention: q [B, Lq, E], k/v [B, Lk, E] -> [B, Lq, E].
    The softmax scale is folded into q before the kernel; differentiable
    through `FlashAttentionBLE`."""
    E = q.shape[-1]
    if E % num_heads:
        raise ValueError(f"E={E} not divisible by num_heads={num_heads}")
    if scale is None:
        scale = (E // num_heads) ** -0.5
    mask = _full_mask(kv_mask, q.shape[0], k.shape[1], q.device)
    return FlashAttentionBLE.apply(_scale_q(q, scale), k, v, mask, num_heads,
                                   bool(mxu_bf16))


def flash_mha(q, k, v, kv_mask=None, scale=None, mxu_bf16: bool = False):
    """Classic-layout flash attention: q [B, H, Lq, D], k/v [B, H, Lk, D] ->
    [B, H, Lq, D]. The softmax scale is folded into q before the kernel;
    differentiable through `FlashAttentionBHLD`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask = _full_mask(kv_mask, q.shape[0], k.shape[2], q.device)
    return FlashAttentionBHLD.apply(_scale_q(q, scale), k, v, mask, bool(mxu_bf16))


def _dim_ge(dim, bound: int) -> bool:
    """`dim >= bound`, False for a symbolic dim (`torch.export` with a
    dynamic sequence length), as the JAX package's `_dim_ge`: such an
    export takes the plain reference, not the blocked one, when the kernels
    are off."""
    return isinstance(dim, int) and dim >= bound


def masked_mha(q, k, v, kv_mask=None, scale=None, use_pallas: bool = True,
               layout: str = "bhld", num_heads: int = None, mxu_bf16: bool = False):
    """Dispatch, as the JAX package's `masked_mha`: the kernels for
    non-tiny query lengths when `use_pallas`, else the plain references
    (which, as the JAX ones, ignore `mxu_bf16`).

    `layout="ble"` (requires `num_heads`): q/k/v and the output are
    [B, L, E]. Single-block shapes (MIN_PALLAS_LQ <= Lq, both L <=
    BLE_MAX_L) take `flash_mha_ble`; other shapes split heads and go
    through the classic dispatch below.

    While `torch.export` traces (`torch.compiler.is_exporting()`), a
    `use_pallas` call is recorded as the one op `gemm_gan_tpu_torch::
    masked_mha`, whose implementation is this dispatch: the route is chosen
    when the exported program runs, from the real shapes."""
    if use_pallas and torch.compiler.is_exporting():
        if layout == "ble" and num_heads is None:
            raise ValueError("layout='ble' requires num_heads")
        return torch.ops.gemm_gan_tpu_torch.masked_mha(q, k, v, kv_mask, scale, layout,
                                                       num_heads or 0, bool(mxu_bf16))
    if layout == "ble":
        if num_heads is None:
            raise ValueError("layout='ble' requires num_heads")
        Lq, Lk = q.shape[1], k.shape[1]
        if (use_pallas and MIN_PALLAS_LQ <= Lq <= BLE_MAX_L
                and Lk <= BLE_MAX_L):
            return flash_mha_ble(q, k, v, kv_mask, scale=scale,
                                 num_heads=num_heads, mxu_bf16=mxu_bf16)
        out = masked_mha(*(_split_heads(x, num_heads) for x in (q, k, v)), kv_mask,
                         scale=scale, use_pallas=use_pallas, mxu_bf16=mxu_bf16)
        return _merge_heads(out)
    if layout != "bhld":
        raise ValueError(f"unknown layout {layout!r}")
    if use_pallas and q.shape[2] >= MIN_PALLAS_LQ:
        return flash_mha(q.contiguous(), k.contiguous(), v.contiguous(),
                         kv_mask, scale=scale, mxu_bf16=mxu_bf16)
    if _dim_ge(q.shape[2], BLOCKED_REF_MIN_LK) or _dim_ge(k.shape[2], BLOCKED_REF_MIN_LK):
        return mha_reference_blocked(q, k, v, kv_mask, scale=scale)
    return mha_reference(q, k, v, kv_mask, scale=scale)


@torch.library.custom_op("gemm_gan_tpu_torch::masked_mha", mutates_args=())
def masked_mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor], scale: Optional[float], layout: str,
                  num_heads: int, mxu_bf16: bool) -> torch.Tensor:
    """`masked_mha(..., use_pallas=True)` as one op of an exported program
    (`num_heads` 0 for the classic layout). On CUDA tensors it launches the
    kernels, counted by their wrappers; on CPU tensors it runs their plain
    versions. Inference only: it has no autograd formula."""
    with torch.no_grad():
        out = masked_mha(q, k, v, kv_mask, scale, use_pallas=True, layout=layout,
                         num_heads=num_heads or None, mxu_bf16=mxu_bf16)
    return out.contiguous()


@masked_mha_op.register_fake
def _masked_mha_fake(q, k, v, kv_mask, scale, layout, num_heads, mxu_bf16):
    return torch.empty_like(q, memory_format=torch.contiguous_format)
