"""GPipe pipeline parallelism over a ``pp`` mesh axis: the counterpart of
``bee_code_interpreter_tpu/parallel/pipeline.py``.

The layers split into contiguous blocks over the ``pp`` ranks (stages):
rank s holds layers ``[s n/S, (s+1) n/S)`` (``stage_block``), as JAX
shards the stacked ``[n_layers, ...]`` leaves on their leading axis. The
batch splits into M microbatches that flow stage to stage; the activation
of microbatch m leaves stage s by ``parallel.mesh.send_to`` and enters
stage s + 1 by ``recv_from`` (JAX's ``lax.ppermute``). JAX runs one
program of M + S - 1 ticks on every rank, in which a rank's first s ticks
and last S - 1 - s ticks (the fill and drain bubbles) apply its layers to
garbage that is masked out. Here each rank runs its M microbatches in
order and nothing else: a stage waits in ``recv_from`` where JAX's would
chew on garbage, so the results are the same and each stage launches its
layers' kernels M times a pass, not M + S - 1.

The backward is the schedule replayed in reverse, owned by one
``torch.autograd.Function``: the forward builds each microbatch's graph
through the rank's layers from a detached input and keeps it; the
backward takes the microbatches from the last to the first, receives the
output gradient from the next stage (the last stage reads its own),
runs ``torch.autograd.grad`` through the kept graph, and sends the input
gradient to the previous stage. Every rank makes its exchanges in the same
order, so gloo's blocking send and receive cannot cross, whatever the
generic autograd engine would order.

The output is the last stage's, broadcast to every pp rank (JAX's masked
``psum``), and a loss computed from it counts once on each rank: the
backward starts from the last stage's gradient alone, and the input's
gradient, which only stage 0 computes, is broadcast back to every rank, so
a replicated embedding before the pipeline gets its whole gradient on
every stage.

The auxiliary loss (``with_aux``, MoE load balancing) is each stage's
sum over its layers and microbatches (the ticks that carry a real
microbatch, which are the only ones run here), summed over pp, divided by
M, and averaged over ``batch_axes``: the same number on every rank of the
mesh. Its backward gives each rank's own terms ``g / (M n)``, n the ranks
of the batch axes, which ``reduce_gradients`` sums over them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from bee_code_interpreter_tpu_torch.parallel.mesh import (
    axis_size,
    batch_shard_of,
    broadcast_from,
    group_rank,
    group_size,
    mesh_groups,
    recv_from,
    send_to,
)


def stage_block(layers: list, mesh, axis: str = "pp") -> list:
    """This rank's contiguous block of ``layers`` (a list of per-layer
    trees) over the ``axis`` stages; raises ValueError when the count does
    not divide."""
    S = axis_size(mesh, axis)
    n = len(layers)
    if n % S:
        raise ValueError(f"{n} layers not divisible by {axis}={S}")
    if S == 1:
        return list(layers)
    per = n // S
    s = group_rank(mesh.get_group(axis))
    return list(layers[s * per:(s + 1) * per])


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class _Plan:
    """What the Function needs besides tensors: the stage's layers and
    body, the pp group, M, and the batch axes' groups."""

    def __init__(self, stage_fn, layers, group, n_microbatches, with_aux,
                 batch_groups):
        self.stage_fn, self.layers = stage_fn, layers
        self.group, self.M = group, n_microbatches
        self.with_aux, self.batch_groups = with_aux, batch_groups

    def apply_stage(self, h: torch.Tensor):
        """The rank's layers on one microbatch: ``(h, aux)``, aux an f32
        scalar (0 without ``with_aux``)."""
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for layer in self.layers:
            if self.with_aux:
                h, a = self.stage_fn(h, layer)
                aux = aux + torch.as_tensor(a, device=h.device).float()
            else:
                h = self.stage_fn(h, layer)
        return h, aux


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plan: _Plan, x, *params):
        group, M = plan.group, plan.M
        S, s = group_size(group), group_rank(group)
        micro = x.chunk(M)
        kept, outs = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for m in range(M):
            inp = micro[m] if s == 0 else recv_from(micro[m], s - 1, group)
            inp = inp.detach().requires_grad_(x.requires_grad)
            with torch.enable_grad():
                y, a = plan.apply_stage(inp)
            kept.append((inp, y, a))
            aux = aux + a.detach()
            if s < S - 1:
                send_to(y.detach(), s + 1, group)
            else:
                outs.append(y.detach())
        out = torch.cat(outs) if s == S - 1 else torch.empty_like(x)
        out = broadcast_from(out, S - 1, group)
        if S > 1:
            dist.all_reduce(aux, group=group)
        aux = aux / M
        n = batch_shard_of(plan.batch_groups)[1]
        for g in plan.batch_groups:
            dist.all_reduce(aux, group=g)
        aux = aux / n
        ctx.plan, ctx.kept, ctx.n_batch = plan, kept, n
        ctx.x_like = (x.shape, x.dtype, x.device)
        ctx.params = params
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        plan, kept = ctx.plan, ctx.kept
        group, M = plan.group, plan.M
        S, s = group_size(group), group_rank(group)
        g_micro = g_out.chunk(M)
        g_a = g_aux / (M * ctx.n_batch)
        wanted = [i for i, p in enumerate(ctx.params) if p.requires_grad]
        grads = [None] * len(ctx.params)
        dx = []
        for m in reversed(range(M)):
            inp, y, a = kept[m]
            gy = g_micro[m] if s == S - 1 else recv_from(y, s + 1, group)
            outputs, seeds = [y], [gy]
            if plan.with_aux and a.requires_grad:
                outputs.append(a)
                seeds.append(g_a)
            inputs = [inp] if inp.requires_grad else []
            inputs += [ctx.params[i] for i in wanted]
            got = torch.autograd.grad(outputs, inputs, seeds,
                                      allow_unused=True) if inputs else []
            if inp.requires_grad:
                g_inp, got = got[0], got[1:]
                if g_inp is None:
                    g_inp = torch.zeros_like(inp)
                if s > 0:
                    send_to(g_inp, s - 1, group)
                else:
                    dx.append(g_inp)
            for i, g in zip(wanted, got):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            kept[m] = None  # this microbatch's graph goes
        g_x = None
        shape, dtype, device = ctx.x_like
        if ctx.needs_input_grad[1]:
            g_x = (torch.cat(dx[::-1]) if s == 0
                   else torch.empty(shape, dtype=dtype, device=device))
            g_x = broadcast_from(g_x, 0, group)
        return (None, g_x, *grads)


def spmd_pipeline(
    stage_fn,
    layer_params: list,
    x: torch.Tensor,
    *,
    mesh,
    axis: str = "pp",
    n_microbatches: int,
    batch_axes: tuple[str, ...] = (),
    with_aux: bool = False,
):
    """Apply the layers to ``x`` pipelined over ``axis``.

    ``stage_fn(h, layer) -> h`` applies ONE layer (with ``with_aux``,
    ``(h, aux)``, aux an f32 scalar loss term). ``layer_params`` is this
    rank's block of the layers, a list of per-layer trees
    (``stage_block`` of the whole list: every stage holds as many). ``x``
    is ``[B, ...]``, the rank's rows of a batch sharded over
    ``batch_axes``, with ``B % n_microbatches == 0``; each layer keeps its
    input's shape and dtype. Every rank of the mesh calls it alike.

    Returns ``[B, ...]`` on every pp rank, equal to the layers applied in
    turn up to rounding, or ``(out, aux)`` with ``with_aux``: aux summed
    over the layers, averaged over the microbatches and ``batch_axes``.
    Differentiable in ``x`` and in the tensors of ``layer_params``."""
    group = mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None
    B = x.shape[0]
    if B % n_microbatches != 0:
        raise ValueError(
            f"batch {B} not divisible by {n_microbatches} microbatches")
    groups = mesh_groups(mesh)
    batch_groups = tuple(getattr(groups, a) for a in batch_axes
                         if getattr(groups, a) is not None)
    plan = _Plan(stage_fn, layer_params, group, n_microbatches, with_aux,
                 batch_groups)
    out, aux = _Pipeline.apply(plan, x, *_tensors(layer_params))
    return (out, aux) if with_aux else out
