"""Ring attention: sequence-parallel masked attention over a mesh axis.

Counterpart of `gemm_gan_tpu/kernels/ring_attention.py`. The sequence axis
is sharded over one axis of the mesh (`model`): each rank holds one block of
queries, keys and values, and the K/V blocks (with their mask) travel round
the ring of that axis' ranks while a running online softmax (m, l, acc)
merges each incoming block. Memory per rank is O(L/n · L/n).

The JAX body is plain jnp (no Pallas), and so is this one: the merge is
plain PyTorch in f32 and autograd differentiates it (first order; attention
is never differentiated twice). The rotation is an autograd Function over
`dist.batch_isend_irecv` (`parallel.comm.rotate_ring`) whose backward sends
the gradients the other way round, as `ppermute`'s transpose does.

Numerics match `mha_reference` (the same masked online softmax); fully
masked rows return 0. Layout [B, H, L, D]. The inputs are the whole
sequence on every rank of the axis (replicated, as the projections leave
them); each rank takes its block, and the output is all-gathered back to the
whole sequence, so the caller sees what `mha_reference` returns.
"""

from __future__ import annotations

from typing import Optional

import torch

from gemm_gan_tpu_torch.kernels.flash_attention import _NEG_INF, mha_reference


def _block_merge(m_prev, l_prev, acc, q, scale, k, v, mask):
    """Merge one incoming KV block into the running online softmax."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    valid = mask[:, None, None, :]
    s = torch.where(valid, s, _NEG_INF)
    m_cur = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.where(valid, torch.exp(s - m_new), 0.0)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, acc_new


def _ring_body(q, k, v, mask, mesh, axis: str, n_shards: int, scale: float):
    """One rank's ring: n_shards merges, the KV block rotated between them."""
    from gemm_gan_tpu_torch.parallel import comm

    B, H, Lq, D = q.shape
    qf = q.float()
    m = torch.full((B, H, Lq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    for i in range(n_shards):
        m, l, acc = _block_merge(m, l, acc, qf, scale, k.float(), v, mask)
        if i < n_shards - 1:  # the last block merged needs no further rotation
            k, v = comm.rotate_ring((k, v), mesh, axis)
            mask = comm.rotate([mask], mesh, axis, +1)[0]
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def ring_mha(q, k, v, kv_mask=None, mesh=None, axis: str = "model",
             batch_axis: Optional[str] = None, scale: Optional[float] = None):
    """Sequence-parallel attention: L sharded over `axis` of `mesh`.

    q, k, v: [B, H, L, D]; kv_mask: [B, L] bool True=valid. Self- or
    cross-attention with Lq == Lk. L is padded to a multiple of the axis
    size (padded keys masked out, padded query rows sliced off). Without a
    mesh, or on a one-rank axis, it is `mha_reference`, as JAX routes it.
    `batch_axis` is JAX's: the mesh axis the batch is sharded over. Each
    rank's tensors here are already its rows of the batch, so it changes
    nothing."""
    from gemm_gan_tpu_torch.parallel import comm

    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_mask is None:
        kv_mask = torch.ones((q.shape[0], k.shape[2]), dtype=torch.bool, device=q.device)
    if mesh is None or mesh.shape[axis] == 1:
        return mha_reference(q, k, v, kv_mask, scale=scale)
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"ring_mha needs Lq == Lk, got {q.shape[2]} and {k.shape[2]}")
    n = mesh.shape[axis]
    L = q.shape[2]
    Lp = -(-L // n) * n
    if Lp != L:
        pad = (0, 0, 0, Lp - L)
        q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
        kv_mask = torch.nn.functional.pad(kv_mask, (0, Lp - L), value=False)
    Ls, i = Lp // n, mesh.index(axis)

    def block(x, dim=2):
        return comm.copy_to(x, mesh, axis).narrow(dim, i * Ls, Ls)

    out = _ring_body(block(q), block(k), block(v), kv_mask.narrow(1, i * Ls, Ls),
                     mesh, axis, n, scale)
    out = comm.gather(out, mesh, axis, dim=2)
    return out[:, :, :L] if Lp != L else out
