"""Pipeline parallelism: GPipe and 1F1B over pipeline stages.

Counterpart of ``accelerate_tpu/parallel/pipeline.py``. The reference is
one SPMD program: a stage-stacked parameter tree sharded over the
``stage`` axis and a belt of activations that advances one stage per
tick, the shift lowered by GSPMD to a neighbour collective-permute. Here
each process runs the stages it holds (:class:`StagePlan`) and hands a
microbatch's activations forward, and its cotangents back, through
:class:`Handoff`: within the process when the neighbouring stage is its
own (an explicit ``pipeline_stages`` on one process, or the consecutive
stages one rank holds when the stage count exceeds the ``stage`` axis),
and with ``batch_isend_irecv`` to the neighbouring rank of the ``stage``
group otherwise (as the ring's ``parallel/context._rotate``).

Both schedules walk the reference's ticks: at tick ``t`` stage ``s``
forwards microbatch ``t - s``. Fill and drain slots are skipped, not
computed and masked, which changes no answer.

- :func:`gpipe`: the forward belt, under autograd (all forwards, then the
  one backward: O(M) microbatch activations per stage). Across ranks the
  backward's cotangents cross through :class:`_FromPrev` /
  :class:`_ToNext`, autograd functions whose backward sends (receives)
  every microbatch's cotangent once all are there.
- :func:`one_f_one_b`: the hand-scheduled PipeDream-flush schedule. Stage
  ``s`` also backwards microbatch ``t - (2S - 1 - s)`` at tick ``t``, a
  rematerialized forward from the input it stashed, so a stage holds at
  most ``2S - 1`` microbatch inputs whatever M is. The head runs only on
  ticks where the last stage finished a real microbatch.

Microbatches are strided (:func:`split_microbatches`): microbatch m holds
rows {m, m + M, m + 2M, ...}, as the reference's.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence

import torch

from .mesh import axis_size

logger = logging.getLogger(__name__)

ACT, COT = "act", "cot"


def pipeline_round_trip_steps(num_microbatches: int, num_stages: int) -> int:
    """GPipe schedule length: fill (S - 1) + stream (M)."""
    return num_microbatches + num_stages - 1


def split_microbatches(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B / M, ...], microbatch m = rows {m, m + M, ...}
    (a view)."""
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(f"batch {b} is not divisible by num_microbatches={num_microbatches}")
    return x.reshape(b // num_microbatches, num_microbatches, *x.shape[1:]).transpose(0, 1)


def merge_microbatches(y) -> torch.Tensor:
    """[M, mb, ...] (or a list of M [mb, ...]) -> [B, ...], the inverse of
    :func:`split_microbatches`."""
    if not isinstance(y, torch.Tensor):
        y = torch.stack(list(y))
    return y.transpose(0, 1).reshape(y.shape[0] * y.shape[1], *y.shape[2:])


def adapt_microbatches(b: int, configured: int, num_stages: int) -> int:
    """The largest M <= ``configured`` dividing batch ``b`` (the
    reference's ``_adapt_microbatches``): odd batches still run, with one
    warning when a real batch degrades."""
    m = configured
    while b % m != 0:
        m -= 1
    if m != configured and b > 1:
        logger.warning(
            "pipeline: batch %d is not divisible by the configured %d microbatches; "
            "running with M=%d. At M < num_stages (%d) the pipeline bubble dominates. "
            "Pick a batch size divisible by pipeline_microbatches.",
            b, configured, m, num_stages)
    return m


def effective_stages(configured: int, num_layers: int, mesh) -> int:
    """Pipeline degree: an explicit ``pipeline_stages`` > 1 wins; else a
    mesh whose ``stage`` axis is > 1 and divides the layers (the
    reference's ``_effective_stages``)."""
    if configured > 1:
        return configured
    n = axis_size(mesh, "stage")
    if n > 1 and num_layers % n == 0:
        return n
    return 1


class StagePlan:
    """Which of ``num_stages`` stages this process runs: all of them on one
    process (or a mesh without a ``stage`` axis); on a ``stage`` axis of n
    ranks, rank r of the stage group runs the S / n consecutive stages
    from r S / n."""

    def __init__(self, num_stages: int, mesh=None):
        n = axis_size(mesh, "stage")
        if num_stages % n:
            raise ValueError(f"{num_stages} pipeline stages do not divide over a stage axis of {n}")
        self.num_stages = num_stages
        self.per_rank = num_stages // n
        self.group = mesh.get_group("stage") if n > 1 else None
        self.ranks = n
        if self.group is None:
            self.rank = 0
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank(self.group)
        self.stages = range(self.rank * self.per_rank, (self.rank + 1) * self.per_rank)

    def owner(self, stage: int) -> int:
        """The stage-group rank that runs ``stage``."""
        return stage // self.per_rank

    def local(self, stage: int) -> bool:
        return self.owner(stage) == self.rank

    @property
    def first(self) -> bool:
        return self.local(0)

    @property
    def last(self) -> bool:
        return self.local(self.num_stages - 1)

    def peer(self, stage: int) -> int:
        """The global rank that runs ``stage``."""
        import torch.distributed as dist

        return dist.get_global_rank(self.group, self.owner(stage))


class Handoff:
    """The stage-to-stage handoff of one schedule run: each tick's
    activations (``ACT``, stage s to s + 1) and cotangents (``COT``, s to
    s - 1), keyed ``(kind, receiving stage, microbatch)``. A message to a
    stage of this process is kept for it; one to another rank is sent with
    ``batch_isend_irecv`` at the start of the next tick, when that rank
    posts the matching receive. Every message has the shape and dtype of
    one microbatch's activations."""

    def __init__(self, plan: StagePlan, shape, dtype, device):
        self.plan = plan
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        self.inbox: dict = {}
        self._outbox: list = []

    def send(self, kind: str, stage: int, mb: int, tensor: torch.Tensor):
        key = (kind, stage, mb)
        if self.plan.local(stage):
            self.inbox[key] = tensor
        else:
            self._outbox.append((key, tensor.detach().contiguous()))

    def take(self, kind: str, stage: int, mb: int) -> torch.Tensor:
        return self.inbox.pop((kind, stage, mb))

    def exchange(self, expected: Sequence[tuple]):
        """Post last tick's sends and this tick's receives (``expected``:
        keys of messages from other ranks), and wait for both."""
        import torch.distributed as dist

        plan = self.plan
        ops = [dist.P2POp(dist.isend, t, plan.peer(stage), group=plan.group)
               for (kind, stage, mb), t in self._outbox]
        self._outbox = []
        for key in expected:
            kind, stage, mb = key
            src = stage - 1 if kind == ACT else stage + 1
            buf = torch.empty(self.shape, dtype=self.dtype, device=self.device)
            self.inbox[key] = buf
            ops.append(dist.P2POp(dist.irecv, buf, plan.peer(src), group=plan.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def send_all(self, stage: int, tensors: Sequence[torch.Tensor]):
        """Every microbatch's tensor, in microbatch order, to the rank that
        runs ``stage`` (GPipe's cotangents, once the backward has them)."""
        import torch.distributed as dist

        ops = [dist.P2POp(dist.isend, t.detach().to(self.dtype).contiguous(),
                          self.plan.peer(stage), group=self.plan.group) for t in tensors]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def recv_all(self, stage: int, count: int) -> list:
        """``count`` tensors from the rank that runs ``stage``, in the
        order :meth:`send_all` sent them."""
        import torch.distributed as dist

        out = [torch.empty(self.shape, dtype=self.dtype, device=self.device)
               for _ in range(count)]
        ops = [dist.P2POp(dist.irecv, t, self.plan.peer(stage), group=self.plan.group)
               for t in out]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


class _Mailbox:
    """The cotangents that reach this rank's first stage in GPipe's
    backward, sent to the previous rank together once all M are in."""

    def __init__(self, handoff: Handoff, stage: int, count: int):
        self.handoff, self.stage, self.count = handoff, stage, count
        self.got: dict = {}

    def put(self, mb: int, grad: torch.Tensor):
        self.got[mb] = grad
        if len(self.got) == self.count:
            self.handoff.send_all(self.stage - 1, [self.got[m] for m in range(self.count)])
            self.got = {}


class _FromPrev(torch.autograd.Function):
    """A microbatch received from the previous rank's stage: its backward
    hands the cotangent to the mailbox. ``anchor`` (a scalar that requires
    grad) keeps the node in the graph."""

    @staticmethod
    def forward(ctx, anchor, x, box, mb):
        ctx.box, ctx.mb = box, mb
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        ctx.box.put(ctx.mb, grad)
        return None, None, None, None


class _ToNext(torch.autograd.Function):
    """The outputs this rank sent to the next rank's stage, tied into its
    loss: the backward receives their cotangents, in microbatch order."""

    @staticmethod
    def forward(ctx, loss, handoff, stage, *ys):
        ctx.handoff, ctx.stage, ctx.count = handoff, stage, len(ys)
        return loss.clone()

    @staticmethod
    def backward(ctx, grad):
        cots = ctx.handoff.recv_all(ctx.stage, ctx.count)
        return (grad, None, None, *cots)


def gpipe(stage_fn: Callable, inputs: Optional[Sequence[torch.Tensor]], num_microbatches: int,
          plan: StagePlan, handoff: Handoff) -> tuple:
    """The GPipe forward over this process's stages, under autograd (its
    backward is the reverse schedule). ``stage_fn(s, m, x) -> (y, aux)``
    runs stage s on microbatch m; ``inputs`` are stage 0's M microbatches
    (None where this process does not run stage 0). Returns ``(outputs,
    aux, tail)``: the last stage's M outputs (None elsewhere), the sum of
    ``aux`` over this process's valid (stage, microbatch) pairs, and
    ``tail(loss) -> loss``, which ties the outputs sent to the next rank
    into this rank's loss (the identity on the last stage)."""
    S, M = plan.num_stages, num_microbatches
    outputs = [None] * M
    sent = []
    aux = 0.0
    box = None
    first = plan.stages[0]
    grad = torch.is_grad_enabled()
    if first > 0 and grad:
        box = _Mailbox(handoff, first, M)
        anchor = torch.zeros((), device=handoff.device, requires_grad=True)
    for t in range(pipeline_round_trip_steps(M, S)):
        expected = [(ACT, first, t - first)] if first > 0 and 0 <= t - first < M else []
        handoff.exchange(expected)
        for s in plan.stages:
            m = t - s
            if not 0 <= m < M:
                continue
            if s == 0:
                x = inputs[m]
            else:
                x = handoff.take(ACT, s, m)
                if s == first and box is not None:
                    x = _FromPrev.apply(anchor, x, box, m)
            y, a = stage_fn(s, m, x)
            aux = aux + a
            if s == S - 1:
                outputs[m] = y
            else:
                handoff.send(ACT, s + 1, m, y)
                if not plan.local(s + 1):
                    sent.append(y)
    handoff.exchange([])  # the last tick's sends
    last = plan.stages[-1]

    def tail(loss):
        if last == S - 1 or not grad:
            return loss
        return _ToNext.apply(loss, handoff, last + 1, *sent)

    return (outputs if plan.last else None), aux, tail


class OneFOneB:
    """What :func:`one_f_one_b` reports: the most microbatch inputs a
    stage held in its stash at once, and the (stage, microbatch) pairs it
    forwarded, backwarded and ran the head on, in order."""

    def __init__(self):
        self.max_stash = 0
        self.forwards: list = []
        self.backwards: list = []
        self.heads: list = []


def one_f_one_b(forward: Callable, backward: Callable, head: Callable,
                inputs: Optional[Sequence[torch.Tensor]], num_microbatches: int,
                plan: StagePlan, handoff: Handoff) -> tuple:
    """The 1F1B (PipeDream-flush) schedule over this process's stages. At
    tick t stage s backwards microbatch ``t - (2S - 1 - s)`` from the input
    it stashed (``backward(s, m, x, cot) -> dx``: the rematerialized
    forward and its backward, which accumulates the stage's gradients),
    then forwards microbatch ``t - s`` (``forward(s, m, x) -> y``, no
    graph) and stashes its input. The last stage's output goes to
    ``head(m, y) -> dy``, the loss's cotangent, which the stage backwards
    at the next tick. Returns ``(dx, stats)``: stage 0's input cotangents
    (None where this process does not run stage 0) and a
    :class:`OneFOneB`."""
    S, M = plan.num_stages, num_microbatches
    stash = {s: {} for s in plan.stages}
    dx_mb = [None] * M
    stats = OneFOneB()
    first, last = plan.stages[0], plan.stages[-1]
    for t in range(M + 2 * S - 1):
        expected = []
        if first > 0 and 0 <= t - first < M:
            expected.append((ACT, first, t - first))
        b_last = t - (2 * S - 1 - last)
        if last < S - 1 and 0 <= b_last < M:
            expected.append((COT, last, b_last))
        handoff.exchange(expected)
        for s in plan.stages:
            b = t - (2 * S - 1 - s)
            if 0 <= b < M:
                dx = backward(s, b, stash[s].pop(b), handoff.take(COT, s, b))
                stats.backwards.append((s, b))
                if s == 0:
                    dx_mb[b] = dx
                else:
                    handoff.send(COT, s - 1, b, dx)
            f = t - s
            if 0 <= f < M:
                x = inputs[f] if s == 0 else handoff.take(ACT, s, f)
                stash[s][f] = x
                stats.max_stash = max(stats.max_stash, len(stash[s]))
                y = forward(s, f, x)
                stats.forwards.append((s, f))
                if s == S - 1:
                    handoff.send(COT, s, f, head(f, y))
                    stats.heads.append(f)
                else:
                    handoff.send(ACT, s + 1, f, y)
    handoff.exchange([])
    return (dx_mb if plan.first else None), stats


class StageTensor:
    """A block's tensor in a checkpoint's entries on a ``stage`` mesh (every
    rank holds only its own stages' blocks): its shape and dtype on every
    rank of the stage group, and, fetched, the whole tensor on each of them
    (its owner's, gathered first where sharded, broadcast over the stage
    group). Every rank fetches every entry, in the same order."""

    def __init__(self, local, shape, dtype, device, group, src: int):
        self.local, self.shape, self.dtype = local, tuple(shape), dtype
        self.device, self.group, self.src = device, group, src

    def detach(self):
        return self

    def to(self, dtype):
        return StageTensor(self.local, self.shape, dtype, self.device, self.group, self.src)

    def fetch_whole(self) -> torch.Tensor:
        import torch.distributed as dist

        from ..models.convert import whole

        if self.local is not None:
            t = whole(self.local.detach()).to(self.dtype).contiguous()
        else:
            t = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        dist.broadcast(t, group=self.group, group_src=self.src)
        return t


def every_stage(model, tensors: dict) -> dict:
    """``tensors`` (a model's weights or moments by parameter name) with
    every layer of its pipelined stack, as :class:`StageTensor` s, where the
    model runs on a ``stage`` axis and holds only its own stages' blocks;
    as given otherwise."""
    if getattr(model, "num_stages", 1) <= 1 or model.stage_plan().group is None:
        return tensors
    plan = model.stage_plan()
    prefix = model.pipeline_stack + "."
    held = model.held_layers()
    per = len(getattr(model, model.pipeline_stack)) // plan.num_stages
    suffixes = [k.split(".", 2)[2] for k in tensors
                if k.startswith(prefix) and k.split(".", 2)[1] == str(held[0])]
    device = next(model.parameters()).device
    out = {k: v for k, v in tensors.items() if not k.startswith(prefix)}
    for i in range(len(getattr(model, model.pipeline_stack))):
        for suffix in suffixes:
            like = tensors[f"{prefix}{held[0]}.{suffix}"]
            out[f"{prefix}{i}.{suffix}"] = StageTensor(
                tensors.get(f"{prefix}{i}.{suffix}"), like.shape, like.dtype, device,
                plan.group, plan.owner(i // per))
    return out
