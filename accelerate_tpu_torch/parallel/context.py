"""Ring attention over the ``sequence`` axis of the mesh.

Counterpart of ``accelerate_tpu/parallel/context.py``. Each rank of a
sequence group holds one chunk of the sequence, in group order: q, k, v
[B, H or KVH, S / n, D]. The kv chunks travel around the ring (to rank
+ 1, from rank - 1, ``batch_isend_irecv``) while each rank attends its
queries to the chunk it holds; the hops' partial outputs merge by their
log-sum-exp in fp32.

Each hop is one (q, kv-chunk) pair and one of three cases
(:func:`case_index`, the reference's ``_hop_cases`` / ``_case_index``):
the chunk lies before this rank's (full: the flash forward kernel #1
with ``causal=False``), it is this rank's own (the diagonal: #1 with
``causal=True``), or it lies after (skip: nothing is launched, zeros and
``NEG_INF``); without ``causal`` every hop is full. The backward walks
the ring again with the merged output and the GLOBAL lse, so p = exp(s -
lse) of each hop is already normalised and the partial gradients of the
hops sum to the whole: dq accumulates where it is, while dk and dv
accumulate on buffers that travel with k and v, n rotations in all, so
each lands back on its chunk's owner (#2 and #3 once per hop that is not
skipped).

:func:`ring_attention` composes the hop functions with the group's
rotation, as a ``torch.autograd.Function`` (the reference's
``custom_vjp``). :func:`ring_lockstep` composes the same functions for
all n ranks of a ring on one device, hop r of every rank and then the
rotation, in the ring's own order of summation: the same tensors as the
ring's, launch for launch.

``impl``: ``"flash"`` takes the kernel wrappers (``ops/kernels.py``: the
kernels on a CUDA tensor, their plain versions on a CPU one), ``"dense"``
the plain versions wherever the tensors are, ``"auto"`` what the port's
``flash_route`` says (the kernels on a CUDA tensor whose chunk and head
dim are 128-multiples).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..ops.attention import (NEG_INF, flash_attention_bwd, flash_attention_with_lse,
                             flash_bwd_dkv_reference, flash_bwd_dq_reference, flash_delta,
                             flash_fwd_reference, flash_route)

FULL, DIAGONAL, SKIP = 0, 1, 2


def case_index(j: int, i: int, causal: bool) -> int:
    """Rank ``i``'s hop over chunk ``j``: FULL (j < i, or not causal),
    DIAGONAL (j == i) or SKIP (j > i)."""
    if not causal:
        return FULL
    return DIAGONAL if j == i else (FULL if j < i else SKIP)


def _plain(impl: str, q: torch.Tensor) -> bool:
    """Whether the hops run the kernels' plain versions."""
    if impl not in ("auto", "flash", "dense"):
        raise ValueError(f"impl must be 'auto', 'flash' or 'dense', got {impl!r}")
    if impl == "auto":
        return not flash_route("auto", q.device, q.shape[2], q.shape[2], q.shape[-1])
    return impl == "dense"


def hop_forward(q, k, v, case: int, sm_scale: float, plain: bool):
    """(out, lse [B, H, Sq] fp32) of one hop: #1 over the chunk pair, or
    nothing at all for SKIP."""
    if case == SKIP:
        return (torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=q.dtype, device=q.device),
                torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device))
    causal = case == DIAGONAL
    if plain:
        masks = (None, None, None)
        return flash_fwd_reference(q.contiguous(), k.contiguous(), v.contiguous(), masks,
                                   causal, sm_scale)
    return flash_attention_with_lse(q, k, v, causal=causal, sm_scale=sm_scale)


def hop_backward(q, k, v, out, lse, do, case: int, sm_scale: float, plain: bool):
    """(dq, dk, dv) of one hop with the ring's merged ``out`` and global
    ``lse``: #2 and #3 over the chunk pair, or zeros for SKIP."""
    if case == SKIP:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    causal = case == DIAGONAL
    if plain:
        masks = (None, None, None)
        q, k, v, do = (t.contiguous() for t in (q, k, v, do))
        lse = lse.float().contiguous()
        delta = flash_delta(out, do)
        dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, masks, causal, sm_scale)
        dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, masks, causal, sm_scale)
        return dq, dk, dv
    return flash_attention_bwd(q, k, v, out, lse, do, causal=causal, sm_scale=sm_scale)


def merge_hop(o_acc, lse_acc, o_r, lse_r):
    """Fold one hop's (out, lse) into the running fp32 (out, lse) by
    ``logaddexp`` (the reference's online softmax across chunks)."""
    new_lse = torch.logaddexp(lse_acc, lse_r)
    w_old = torch.exp(lse_acc - new_lse)[..., None]
    w_new = torch.exp(lse_r - new_lse)[..., None]
    return o_acc * w_old + o_r.float() * w_new, new_lse


def _forward_start(q, v):
    return (torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32, device=q.device),
            torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device))


def _rotate(tensors: Sequence[torch.Tensor], group) -> list:
    """Each tensor sent to the next rank of ``group`` and replaced by the
    previous rank's (one ``batch_isend_irecv``)."""
    import torch.distributed as dist

    n, i = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + 1) % n)
    src = dist.get_global_rank(group, (i - 1) % n)
    out = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group=group))
        ops.append(dist.P2POp(dist.irecv, r, src, group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale, plain):
        import torch.distributed as dist

        n, i = dist.get_world_size(group), dist.get_rank(group)
        o_acc, lse_acc = _forward_start(q, v)
        k_cur, v_cur = k, v
        for r in range(n):
            case = case_index((i - r) % n, i, causal)
            o_r, lse_r = hop_forward(q, k_cur, v_cur, case, sm_scale, plain)
            o_acc, lse_acc = merge_hop(o_acc, lse_acc, o_r, lse_r)
            if r != n - 1:
                k_cur, v_cur = _rotate((k_cur, v_cur), group)
        out = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_acc)
        ctx.group, ctx.causal, ctx.sm_scale, ctx.plain = group, causal, sm_scale, plain
        return out

    @staticmethod
    def backward(ctx, do):
        import torch.distributed as dist

        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, i = dist.get_world_size(group), dist.get_rank(group)
        do = do.contiguous()
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for r in range(n):
            case = case_index((i - r) % n, i, ctx.causal)
            dq_r, dk_r, dv_r = hop_backward(q, k_cur, v_cur, out, lse, do, case,
                                            ctx.sm_scale, ctx.plain)
            dq_acc = dq_acc + dq_r.float()
            dk_cur = dk_cur + dk_r.float()
            dv_cur = dv_cur + dv_r.float()
            # dk / dv rotate after every hop (n in all) to land on their
            # owner; k / v need n - 1
            if r != n - 1:
                k_cur, v_cur, dk_cur, dv_cur = _rotate((k_cur, v_cur, dk_cur, dv_cur), group)
            else:
                dk_cur, dv_cur = _rotate((dk_cur, dv_cur), group)
        return (dq_acc.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, *, group, causal: bool = True,
                   sm_scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """Attention of this rank's query chunk over the whole sequence, whose
    chunks the ranks of ``group`` hold in group order: q [B, H, S / n, D],
    k / v [B, KVH, S / n, D] (KVH divides H; grouped, never expanded).
    Differentiable: the backward runs the ring of #2 / #3."""
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads ({q.shape[1]}) must be a multiple of kv heads "
                         f"({k.shape[1]})")
    return _Ring.apply(q, k, v, group, bool(causal), float(sm_scale), _plain(impl, q))


def ring_attention_sharded(q, k, v, mesh, *, causal: bool = True,
                           sm_scale: Optional[float] = None, seq_axis: str = "sequence",
                           impl: str = "auto") -> torch.Tensor:
    """This rank's chunk of attention over the mesh's ``seq_axis`` (the
    reference's global-view entry: here each rank passes the chunk it
    holds). A trivial axis falls back to plain attention
    (``dot_product_attention``), as the reference's does."""
    from .mesh import axis_size

    n = axis_size(mesh, seq_axis)
    if n == 1:
        from ..ops.attention import dot_product_attention

        return dot_product_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                     impl="xla" if impl == "dense" else impl)
    return ring_attention(q, k, v, group=mesh.get_group(seq_axis), causal=causal,
                          sm_scale=sm_scale, impl=impl)


def ring_lockstep(qs, ks, vs, dos=None, *, causal: bool = True,
                  sm_scale: Optional[float] = None, impl: str = "auto"):
    """The ring of ``len(qs)`` ranks composed on one device: rank p holds
    chunk p (``qs[p]``, ``ks[p]``, ``vs[p]``); each hop runs for every
    rank, then the chunks rotate (rank p takes rank p - 1's), with the
    same hop and merge functions and order of summation as
    :func:`ring_attention`. Returns the outputs and, given the output
    gradients ``dos``, ``(dqs, dks, dvs)``."""
    n = len(qs)
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(qs[0].shape[-1])
    plain = _plain(impl, qs[0])

    def rotate(chunks):
        return [chunks[(p - 1) % n] for p in range(n)]

    acc = [_forward_start(qs[p], vs[p]) for p in range(n)]
    k_cur, v_cur = list(ks), list(vs)
    for r in range(n):
        for p in range(n):
            case = case_index((p - r) % n, p, causal)
            o_r, lse_r = hop_forward(qs[p], k_cur[p], v_cur[p], case, sm_scale, plain)
            acc[p] = merge_hop(*acc[p], o_r, lse_r)
        if r != n - 1:
            k_cur, v_cur = rotate(k_cur), rotate(v_cur)
    outs = [o.to(qs[p].dtype) for p, (o, _) in enumerate(acc)]
    if dos is None:
        return outs
    lses = [lse for _, lse in acc]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    dos = [d.contiguous() for d in dos]
    k_cur, v_cur = list(ks), list(vs)
    for r in range(n):
        for p in range(n):
            case = case_index((p - r) % n, p, causal)
            dq_r, dk_r, dv_r = hop_backward(qs[p], k_cur[p], v_cur[p], outs[p], lses[p], dos[p],
                                       case, sm_scale, plain)
            dq[p] = dq[p] + dq_r.float()
            dk[p] = dk[p] + dk_r.float()
            dv[p] = dv[p] + dv_r.float()
        if r != n - 1:
            k_cur, v_cur = rotate(k_cur), rotate(v_cur)
        dk, dv = rotate(dk), rotate(dv)
    return outs, ([d.to(q.dtype) for d, q in zip(dq, qs)],
                  [d.to(k.dtype) for d, k in zip(dk, ks)],
                  [d.to(v.dtype) for d, v in zip(dv, vs)])


def next_chunk_first(labels: torch.Tensor, mesh, seq_axis: str = "sequence") -> torch.Tensor:
    """[B]: the first label of the next rank's chunk along ``seq_axis``
    (what this chunk's last position predicts), -100 (ignored) on the
    last rank's."""
    import torch.distributed as dist

    group = mesh.get_group(seq_axis)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    firsts = [torch.empty_like(labels[:, 0]) for _ in range(n)]
    dist.all_gather(firsts, labels[:, 0].contiguous(), group=group)
    return firsts[i + 1] if i + 1 < n else torch.full_like(labels[:, 0], -100)


def gather_sequence(x: torch.Tensor, mesh, seq_axis: str = "sequence") -> torch.Tensor:
    """The whole sequence from every rank's chunk along dim 1 (no
    gradient): what a bidirectional model attends over on a ``sequence``
    axis, as the reference's partitioned attention does."""
    import torch.distributed as dist

    group = mesh.get_group(seq_axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)
