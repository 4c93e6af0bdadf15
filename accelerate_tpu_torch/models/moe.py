"""Mixture-of-Experts FFN: capacity-bounded top-k routing per group.

Counterpart of ``accelerate_tpu/models/moe.py``. Tokens are routed per
GROUP, one group per batch row of the forward that runs them: each
expert takes at most ``capacity`` tokens of a group, queue positions are
given in token order (first come, first served, a token's k choices in
rank order), and a token whose slot lands past the capacity is dropped
(its expert contribution is zero; the residual still carries it). So a
token's output depends on the other rows of its group: a serving engine
has to form the reference engine's groups (the same rows, pads and
positions) to give its tokens.

The router runs in fp32 with the Switch load-balancing loss. The
reference builds one-hot dispatch and combine tensors ``[g, n, E, c]``
and contracts them with einsums; here the same routing fills a slot
table (which token sits at each of an expert's ``c`` queue positions)
and gathers: the values are the one-hot products' (a single nonzero term
in each sum), without the ``[g, n, E, c]`` tensors. The expert banks
``w_gate`` / ``w_up`` ``[E, d, m]`` and ``w_down`` ``[E, m, d]`` run as
batched matmuls over ``[E, g * c, d]``. No TPU kernel is involved: the
reference computes all of it in XLA.
"""

from __future__ import annotations

import torch

from ..ops.layers import swiglu
from .decoder import _Module


def compute_capacity(group_size: int, num_experts: int, top_k: int, factor: float) -> int:
    """Static per-expert queue length within one routing group."""
    return max(1, int(group_size * top_k * factor / num_experts))


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, largest first,
    ties to the lower index (``torch.topk`` leaves tie order open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row
    (``F.one_hot`` raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(router_probs: torch.Tensor, top_k: int, capacity: int):
    """``(gate_vals [g, n, k] fp32, gate_idx [g, n, k], pos [g, n, k],
    keep [g, n, k] bool, aux)``: each slot's renormalized gate, expert,
    queue position within its group and expert, whether it fits the
    capacity, and the Switch aux loss ``E * sum_e f_e * P_e`` (top-1
    fractions, averaged over groups)."""
    g, n, num_experts = router_probs.shape
    gate_vals, gate_idx = _top_k(router_probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # slot -> expert one-hot, token-major then rank-major, so queue
    # positions are deterministic
    flat = _one_hot(gate_idx, num_experts, torch.int64).reshape(g, n * top_k, num_experts)
    queue_pos = torch.cumsum(flat, dim=1) - flat
    pos = (queue_pos * flat).sum(-1).reshape(g, n, top_k)
    keep = pos < capacity
    fraction = _one_hot(gate_idx[..., 0], num_experts, torch.float32).mean(1)  # [g, e]
    mean_prob = router_probs.mean(1)
    aux = num_experts * (fraction * mean_prob).sum(-1).mean()
    return gate_vals, gate_idx, pos, keep, aux


def top_k_routing(router_probs: torch.Tensor, top_k: int, capacity: int):
    """The reference's ``(dispatch [g, n, E, c], combine [g, n, E, c],
    aux_loss)`` from router probabilities ``[g, n, E]`` fp32: dispatch 1
    where a kept slot sends its token to (expert, queue position), combine
    its renormalized gate there. :class:`MoeMLP` routes through the same
    choices without building these."""
    g, n, num_experts = router_probs.shape
    gate_vals, gate_idx, pos, keep, aux = _route(router_probs, top_k, capacity)
    kept = keep.float()
    expert_onehot = _one_hot(gate_idx, num_experts, torch.float32)
    pos_onehot = _one_hot(pos, capacity, torch.float32)
    dispatch = torch.einsum("gnke,gnkc,gnk->gnec", expert_onehot, pos_onehot, kept)
    combine = torch.einsum("gnke,gnkc,gnk,gnk->gnec", expert_onehot, pos_onehot, kept,
                           gate_vals)
    return dispatch, combine, aux


class MoeMLP(_Module):
    """The dense MLP's drop-in: ``forward(x [b, s, d]) -> (y, aux_loss)``,
    each batch row one routing group."""

    def __init__(self, config, device, param_dtype):
        super().__init__()
        e, m, n = config.embed_dim, config.mlp_dim, config.moe_num_experts
        self.config = config
        self.router = self._param((e, n), device, param_dtype)
        self.w_gate = self._param((n, e, m), device, param_dtype)
        self.w_up = self._param((n, e, m), device, param_dtype)
        self.w_down = self._param((n, m, e), device, param_dtype)

    def forward(self, x: torch.Tensor):
        cfg = self.config
        num_experts, k, dt = cfg.moe_num_experts, cfg.moe_top_k, cfg.dtype
        g, n, d = x.shape
        logits = x.float() @ self._use(self.router, torch.float32)
        probs = torch.softmax(logits, dim=-1)
        capacity = compute_capacity(n, num_experts, k, cfg.moe_capacity_factor)
        gate_vals, gate_idx, pos, keep, aux = _route(probs, k, capacity)

        # the slot table: which token fills each (expert, queue position)
        # of a group; an empty slot reads row n, a zero row. Dropped slots
        # write a spare last column, cut off after
        slots = num_experts * capacity
        where = torch.where(keep, gate_idx * capacity + pos, slots).reshape(g, n * k)
        token = torch.arange(n, device=x.device).repeat_interleave(k).expand(g, n * k)
        table = torch.full((g, slots + 1), n, dtype=torch.int64, device=x.device)
        table.scatter_(1, where, token)
        x_pad = torch.cat([x, x.new_zeros(g, 1, d)], dim=1)
        expert_in = x_pad.gather(1, table[:, :slots, None].expand(g, slots, d))
        # [g, E * c, d] -> [E, g * c, d]: each expert's bank over its queues
        expert_in = expert_in.reshape(g, num_experts, capacity, d).transpose(0, 1)
        expert_in = expert_in.reshape(num_experts, g * capacity, d)
        gate = torch.bmm(expert_in, self._use(self.w_gate, dt))
        up = torch.bmm(expert_in, self._use(self.w_up, dt))
        out = torch.bmm(swiglu(gate, up), self._use(self.w_down, dt))
        out = out.reshape(num_experts, g, capacity, d).transpose(0, 1).reshape(g, slots, d)

        # combine: each token's kept slots, weighted by their gates cast
        # to the compute dtype, summed in fp32 as the reference's einsum
        # accumulates
        out_pad = torch.cat([out, out.new_zeros(g, 1, d)], dim=1)
        picked = out_pad.gather(1, where[..., None].expand(g, n * k, d)).reshape(g, n, k, d)
        weight = torch.where(keep, gate_vals, 0.0).to(dt)
        y = (picked.float() * weight.float()[..., None]).sum(2)
        return y.to(dt), aux
