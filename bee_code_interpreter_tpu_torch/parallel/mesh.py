"""Device meshes, the launcher's environment and the collectives and
exchanges of the port: the counterpart of
``bee_code_interpreter_tpu/parallel/mesh.py``.

The JAX package is single-controller: one process drives every device of a
``jax.sharding.Mesh`` and GSPMD inserts the collectives. The port is SPMD
over ``torch.distributed``: one process (rank) per device, a
``torch.distributed.device_mesh.DeviceMesh`` naming the axes, and the
collectives written out in the model functions (``all_reduce_partial``,
``all_gather_cat``, ``broadcast_from``) and in the sequence-parallel
attention (``ring_shift``, ``all_to_all_tiled``: JAX's ``lax.ppermute``
and ``lax.all_to_all``). A rank's "sharding" is its slice of a tensor plus the
spec that says which slice (``shard_tensor``), never a DTensor that
redistributes behind the code's back.

The contract of serving under a mesh (``models/serving.py``): every rank
builds the same ``ContinuousBatcher(mesh=...)``, calls ``submit`` /
``step`` / ``cancel`` / ``state_dict`` in the same order with the same
arguments, and the caller reads rank 0's results (every rank's are the
same: each samples on the host from the same all-gathered logits).
Data-parallel serving is a set of such batchers, one per coordinate of a
``dp`` axis (``replica_mesh``), behind a front end on rank 0 that talks to
the other ranks over a gloo group of its own (``control_group``;
``models/replicated.py``).

Training under a mesh (``models/transformer.py``) shards the batch over
the batch axes (``dp``, then ``fsdp``: ``batch_shard_of``), the weights by
``param_specs`` (Megatron over ``tp``, experts over ``ep``, the weights'
other dim over ``fsdp``), and differentiates through the collectives:
``all_reduce_partial`` is Megatron's ``g`` (a sum forward, the identity
backward), ``copy_to_group`` its ``f`` (the identity forward, a sum
backward), and ``gather_shards`` is the fsdp
gather, whose backward sums every rank's gradient and keeps the rank's
block (a reduce-scatter). Every sum adds in f32 and rounds once, so the
ranks agree bit for bit. Under ``sp`` a rank holds a block of positions:
the exchanges of the ring and of Ulysses are differentiable
(``all_to_all_tiled``'s backward is the inverse all-to-all; the ring owns
its backward, ``parallel/ring_attention.py``), and ``reduce_gradients``
sums every gradient over sp, where each leaf is whole. Under ``pp`` a rank
holds a block of layers and the pipeline (``parallel/pipeline.py``) moves
activations and their gradients between neighbouring stages with
``send_to`` / ``recv_from``.

Two conventions for a loss. A loss that each rank holds a share of (its
batch rows, its positions) is summed by ``all_reduce_partial``, whose
backward hands every rank the whole gradient of its share; the parameter
gradients are then partial and ``reduce_gradients`` sums them. A loss
that every rank computes whole from a replicated tensor (the standalone
sp entries' gathered output, the pipeline's output on every stage) counts
once on each rank: ``gather_from_group``'s backward keeps the rank's own
block of the gradient, and ``split_to_group``'s (a replicated input cut to
the rank's block) gathers the blocks' gradients, so every rank holds the
whole gradient of the replicated input, not sp copies of it.

Ranks come from a launcher (``torchrun``, or a pod group that bakes the JAX
names ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``), read by ``initialize_distributed``, or from ``spawn``,
the test and smoke harness's launcher (``spawn`` start method, ``file://``
rendezvous in a temporary directory). The device type is CUDA unless the
caller names the CPU; the backend is NCCL for CUDA and gloo for the CPU
unless the caller names one (gloo also carries CUDA tensors, staged through
host memory: how two ranks share one card, where NCCL refuses).
"""

from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import math
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def _check_device_type(device_type: str) -> None:
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device_type='cpu' to run the ranks "
            "on the CPU (gloo)"
        )


def default_backend(device_type: str) -> str:
    """NCCL for CUDA, gloo for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def _set_local_device(rank: int) -> None:
    """Make this rank's card the current CUDA device: ``LOCAL_RANK`` (or
    the rank) modulo the visible cards, so ranks beyond the card count
    share cards in turn."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    torch.cuda.set_device(local % torch.cuda.device_count())


def distributed_env() -> tuple[int, int, str | None]:
    """(world size, rank, ``host:port`` of the rendezvous) from the
    launcher's environment: torchrun's ``WORLD_SIZE`` / ``RANK`` /
    ``MASTER_ADDR`` (+ ``MASTER_PORT``, default 29500), else the pod
    group's ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` /
    ``JAX_COORDINATOR_ADDRESS``; one process with no address when neither
    is set."""
    env = os.environ
    world = int(env.get("WORLD_SIZE") or env.get("JAX_NUM_PROCESSES") or 1)
    rank = int(env.get("RANK") or env.get("JAX_PROCESS_ID") or 0)
    if env.get("MASTER_ADDR"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    else:
        addr = env.get("JAX_COORDINATOR_ADDRESS")
    return world, rank, addr


def initialize_distributed(backend: str | None = None, *,
                           device_type: str = "cuda") -> bool:
    """Join the process group the launcher's environment describes
    (``distributed_env``). Idempotent; a no-op returning False for one
    process. On CUDA the rank's card becomes the current device first."""
    world, rank, addr = distributed_env()
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    _check_device_type(device_type)
    if addr is None:
        raise ValueError(
            f"WORLD_SIZE/JAX_NUM_PROCESSES is {world} but no rendezvous "
            "address is set (MASTER_ADDR or JAX_COORDINATOR_ADDRESS)"
        )
    if device_type == "cuda":
        _set_local_device(rank)
    dist.init_process_group(backend or default_backend(device_type),
                            init_method=f"tcp://{addr}", rank=rank,
                            world_size=world)
    return True


def local_device_count(device_type: str = "cuda") -> int:
    """Devices this host gives the port: the visible cards (raises without
    CUDA), or one for the CPU (one device per rank process)."""
    _check_device_type(device_type)
    return torch.cuda.device_count() if device_type == "cuda" else 1


def world_size() -> int:
    """Ranks in the default process group (1 when there is none): under
    SPMD each rank is one device, so this is the mesh's device count."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A named assignment of the device grid: axis name -> size."""

    axes: dict[str, int]

    @property
    def n_devices(self) -> int:
        return math.prod(self.axes.values())

    def names(self) -> tuple[str, ...]:
        return tuple(self.axes.keys())


def make_mesh(axes: dict[str, int], *, device_type: str = "cuda",
              backend: str | None = None):
    """A ``DeviceMesh`` with the given axis sizes over the ranks, in dict
    order (the last axis varies fastest: put tp last so a tp group is
    adjacent ranks, which are a host's adjacent cards under torchrun).

    Joins the launcher's process group when there is none
    (``initialize_distributed``, with ``backend`` or the device type's
    default); a lone process gets a group of one. An existing group is
    used as it is (its backend must be ``backend`` when one is named). Raises
    ValueError when the plan needs more devices than there are ranks, and
    without CUDA unless ``device_type="cpu"``."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    _check_device_type(device_type)
    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise ValueError(
                f"the process group runs {dist.get_backend()}, the mesh "
                f"asked for {backend}"
            )
    elif not initialize_distributed(backend, device_type=device_type):
        if device_type == "cuda":
            _set_local_device(0)
        dist.init_process_group(backend or default_backend(device_type),
                                store=dist.HashStore(), rank=0, world_size=1)
    plan = MeshPlan(dict(axes))
    world = dist.get_world_size()
    if plan.n_devices > world:
        raise ValueError(
            f"mesh plan {axes} needs {plan.n_devices} devices, have {world}"
        )
    shape = tuple(plan.axes.values())
    if plan.n_devices == world:
        return init_device_mesh(device_type, shape,
                                mesh_dim_names=plan.names())
    # the first n ranks, as JAX takes the first n devices; every rank must
    # still build it (the others get no coordinate)
    grid = torch.arange(plan.n_devices).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=plan.names())


def auto_mesh(n_devices: int | None = None, *, sp: int = 1,
              device_type: str = "cuda", backend: str | None = None):
    """JAX's default mesh: tp over adjacent ranks (the largest of 8, 4, 2
    that divides the rest), dp over the rest, ``sp`` > 1 carving a
    sequence axis; ``n_devices`` defaults to the ranks there are."""
    total = n_devices or world_size()
    if total % sp != 0:
        raise ValueError(f"{total} devices not divisible by sp={sp}")
    rest = total // sp
    tp = 1
    for candidate in (8, 4, 2):
        if rest % candidate == 0:
            tp = candidate
            break
    return make_mesh({"dp": rest // tp, "sp": sp, "tp": tp},
                     device_type=device_type, backend=backend)


# ----------------------------------------------------------- mesh queries


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError(f"{mesh!r} is not a DeviceMesh with axis names "
                         "(build it with make_mesh)")
    return {name: int(size) for name, size in zip(names, mesh.mesh.shape)}


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 when the mesh has no such axis or no mesh)."""
    return 1 if mesh is None else axis_sizes(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without the axis)."""
    sizes = axis_sizes(mesh)
    if axis not in sizes:
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return int(coord[list(sizes).index(axis)])


def tp_group(mesh):
    """The process group of this rank's tp axis, or None when the mesh has
    no tp axis of size > 1 (no collective to make)."""
    if axis_size(mesh, "tp") <= 1:
        return None
    return mesh.get_group("tp")


def sp_group(mesh):
    """The process group of this rank's sp axis (sequence-parallel
    admission), or None without an sp axis of size > 1."""
    if axis_size(mesh, "sp") <= 1:
        return None
    return mesh.get_group("sp")


def ep_group(mesh):
    """The process group of this rank's ep axis (expert parallelism), or
    None without an ep axis of size > 1."""
    if axis_size(mesh, "ep") <= 1:
        return None
    return mesh.get_group("ep")


def batch_axes(mesh) -> tuple[str, ...] | None:
    """The data-parallel-ish axes an activation batch dim shards over."""
    if mesh is None:
        return None
    axes = tuple(a for a in ("dp", "fsdp") if a in axis_sizes(mesh))
    return axes or None


def batch_shard_of(groups) -> tuple[int, int]:
    """(this rank's block of the batch dim, the number of blocks) from the
    batch axes' groups (dp, then fsdp; one group or a tuple): the batch
    splits over dp then fsdp, dp major, as JAX's ``P(("dp", "fsdp"))``
    lays it out; (0, 1) without a group."""
    index, count = 0, 1
    for g in _group_list(groups):
        n = dist.get_world_size(g)
        index, count = index * n + dist.get_rank(g), count * n
    return index, count


def batch_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` (dim 0), ``batch_shard_of``
    its batch axes' groups: the counterpart of JAX's ``batch_sharding()``."""
    index, count = batch_shard_of(mesh_groups(mesh).batch)
    if x.shape[0] % count:
        raise ValueError(
            f"a batch of {x.shape[0]} rows does not split over {count} "
            "batch shards"
        )
    rows = x.shape[0] // count
    return x[index * rows:(index + 1) * rows]


def replica_mesh(mesh):
    """This rank's replica of a ``{"dp": n, "tp": tp}`` mesh: the tp
    sub-mesh at its dp coordinate (``mesh["tp"]``), the mesh one serving
    replica's batcher runs on."""
    sizes = axis_sizes(mesh)
    if set(sizes) != {"dp", "tp"}:
        raise ValueError(
            f"replicas need a mesh of exactly the axes dp and tp, got {sizes}"
        )
    return mesh["tp"]


def control_group(mesh):
    """A gloo group over every rank of ``mesh``, for host messages (the
    replicated front end's requests and reports): they never ride a NCCL
    group, and never interleave with the collectives of the model. Every
    rank of the default group must call it, in the same order."""
    ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())
    return dist.new_group(ranks=ranks, backend="gloo")


def mesh_shape_key(mesh) -> str:
    """Stable string key for a mesh's axis sizes (``"dp=2,tp=4"``), the
    bucket step telemetry aggregates under; ``"1"`` with no mesh."""
    if mesh is None:
        return "1"
    key = ",".join(f"{name}={size}" for name, size in axis_sizes(mesh).items())
    return key or "1"


def _platform(device_type: str) -> str:
    """A device type as JAX names its platform (``gpu`` for CUDA)."""
    return "gpu" if device_type == "cuda" else device_type


def mesh_descriptor(mesh) -> dict:
    """JSON-able description of a mesh, JAX's keys: axis names and sizes,
    the shape key, the device counts, this process's rank and its
    coordinates in the grid (``DeviceMesh.get_coordinate``), and the
    platform. Under SPMD a rank holds one device of the mesh, where JAX's
    single controller holds all of them (``n_local_devices``). With no
    mesh, the single-device degradation: axes ``{}``, shape ``"1"``."""
    process_index = dist.get_rank() if dist.is_initialized() else 0
    if mesh is None:
        return {
            "axes": {}, "shape": "1", "n_devices": 1, "n_local_devices": 1,
            "process_index": process_index, "coords": {},
            "platform": _platform(
                "cuda" if torch.cuda.is_available() else "cpu"),
        }
    sizes = axis_sizes(mesh)
    coord = mesh.get_coordinate()
    return {
        "axes": sizes,
        "shape": mesh_shape_key(mesh),
        "n_devices": int(mesh.mesh.numel()),
        "n_local_devices": 0 if coord is None else 1,
        "process_index": process_index,
        "coords": ({} if coord is None
                   else {name: int(i) for name, i in zip(sizes, coord)}),
        "platform": _platform(mesh.device_type),
    }


# the axes one batcher serves over, the axes training shards over, and what
# the others wait for or are instead
SERVING_AXES = ("tp", "sp", "ep")
TRAINING_AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp")
_SERVING_ELSEWHERE = {
    "dp": "data-parallel serving is ReplicatedEngine.build(meshes=...), one "
          "batcher per dp coordinate",
    "fsdp": "fsdp shards training state (Transformer.make_train_step)",
    "pp": "pp pipelines training (transformer.forward_pipelined)",
}


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """The process groups of a mesh's axes, each None where its axis is
    absent or of size 1 (no collective to make): tensor parallelism
    (``tp``), sequence parallelism (``sp``), expert parallelism (``ep``),
    the batch axes (``dp``, ``fsdp``) and the pipeline's stages (``pp``)."""

    tp: object = None
    sp: object = None
    ep: object = None
    dp: object = None
    fsdp: object = None
    pp: object = None

    def size(self, axis: str) -> int:
        return group_size(getattr(self, axis))

    @property
    def batch(self) -> tuple:
        """The batch axes' groups (dp, then fsdp), those of size > 1."""
        return tuple(g for g in (self.dp, self.fsdp) if g is not None)


def _axis_group(mesh, axis: str):
    return mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None


def mesh_groups(mesh) -> MeshGroups:
    """The ``MeshGroups`` of a mesh the port runs a model on. An axis of
    size > 1 that no path runs raises ``NotImplementedError``."""
    if mesh is None:
        return MeshGroups()
    for axis, size in axis_sizes(mesh).items():
        if size > 1 and axis not in TRAINING_AXES:
            raise NotImplementedError(
                f"mesh axis {axis}={size}: no path runs it")
    return MeshGroups(**{axis: _axis_group(mesh, axis)
                         for axis in TRAINING_AXES})


def serving_groups(mesh) -> MeshGroups:
    """The groups of a mesh one batcher serves on. An axis outside
    ``SERVING_AXES`` may not exceed size 1 inside one batcher:
    ``NotImplementedError`` says where its work is done instead."""
    if mesh is None:
        return MeshGroups()
    for axis, size in axis_sizes(mesh).items():
        if axis not in SERVING_AXES and size > 1:
            why = _SERVING_ELSEWHERE.get(axis, "no path runs it")
            raise NotImplementedError(
                f"serving over mesh axis {axis}={size} inside one batcher: "
                f"{why}"
            )
    return MeshGroups(tp=tp_group(mesh), sp=sp_group(mesh),
                      ep=ep_group(mesh))


# ------------------------------------------------------------- shardings


class ColumnSpec(tuple):
    """A spec (axis names, one per dim) whose last dim each rank of
    ``axis`` holds as columns of the whole tensor picked by index, not as
    an even block: ``columns[r]`` are the ``whole`` tensor's columns rank r
    holds, in its order, and a column may lie on several ranks (copies) or
    twice on one. The other dims shard as a plain spec's. It is what
    ``wk``/``wv`` take where tp does not divide ``kv_heads``: a rank's K/V
    heads of the ``lcm(kv_heads, tp)`` broadcast
    (``models/transformer.py::kv_columns``). ``reduce_gradients`` sums each
    column's gradient over its copies."""

    def __new__(cls, names, axis: str, whole: int, columns):
        spec = super().__new__(cls, names)
        spec.axis, spec.whole = axis, whole
        spec.columns = tuple(columns)
        return spec

    def __reduce__(self):
        return ColumnSpec, (tuple(self), self.axis, self.whole, self.columns)

    def renamed(self, names) -> "ColumnSpec":
        """The same columns under other names (a factor's or a scale's
        spec, whose last dim follows the weight's)."""
        return ColumnSpec(names, self.axis, self.whole, self.columns)

    def cols(self, mesh) -> torch.Tensor:
        """The whole tensor's columns this rank holds."""
        return self.columns[axis_index(mesh, self.axis)]

    def even_block(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's even block of the last dim (a plain spec's shard)
        out of ``x``, the rank's columns: what a checkpoint saves. Each
        block lies within the rank's columns (its broadcast heads cover the
        same span of the whole as the block)."""
        n, r = axis_size(mesh, self.axis), axis_index(mesh, self.axis)
        if self.whole % n:
            raise ValueError(
                f"{self.whole} columns do not divide over {self.axis}={n}")
        want = range(r * self.whole // n, (r + 1) * self.whole // n)
        held = self.cols(mesh).tolist()
        missing = [c for c in want if c not in held]
        if missing:
            raise ValueError(f"rank {r} of {self.axis} holds no column "
                             f"{missing[0]} of its even block")
        pos = torch.tensor([held.index(c) for c in want])
        return x.index_select(-1, pos.to(x.device))


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` under
    ``spec`` (a tuple of axis names or None, one per dim; shorter specs
    leave the trailing dims whole): a Megatron split over ``tp``, experts
    over ``ep``, a sequence over ``sp``; a ``ColumnSpec``'s last dim is the
    rank's columns."""
    if isinstance(spec, ColumnSpec):
        return (*local_shape(shape[:-1], spec[:-1], mesh),
                len(spec.cols(mesh)))
    out = list(shape)
    for dim, axis in enumerate(spec):
        n = axis_size(mesh, axis) if axis is not None else 1
        if out[dim] % n:
            raise ValueError(
                f"dim {dim} of {tuple(shape)} does not divide over "
                f"{axis}={n}"
            )
        out[dim] //= n
    return tuple(out)


def shard_tensor(x: torch.Tensor, spec, mesh, device) -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec``, as a contiguous tensor of
    its own on ``device`` (a fresh allocation even where ``x`` already
    lives there): along each dim named by an axis of size > 1, the
    contiguous block at the rank's coordinate on that axis, as JAX's
    ``NamedSharding`` lays it out (a sequence split over ``sp`` gives rank
    r the positions ``[r L/sp, (r+1) L/sp)``); under a ``ColumnSpec``
    the last dim's columns are the rank's."""
    shape = local_shape(x.shape, spec, mesh)
    out = x
    whole_dims = len(spec) - isinstance(spec, ColumnSpec)
    for dim, axis in enumerate(spec[:whole_dims]):
        if axis is None or axis_size(mesh, axis) == 1:
            continue
        n = shape[dim]
        out = out.narrow(dim, axis_index(mesh, axis) * n, n)
    if isinstance(spec, ColumnSpec):
        out = out.index_select(-1, spec.cols(mesh).to(out.device))
    return out.detach().to(device, copy=True).contiguous()


# --------------------------------------------------- tensor-parallel ops


def group_size(group) -> int:
    """Ranks in ``group``; 1 for None (no tensor parallelism)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``; 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def _group_list(group) -> list:
    """``group`` (None, a group, or a tuple of them) as a list of groups."""
    return [g for g in (group if isinstance(group, tuple) else (group,))
            if g is not None]


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _sum_f32(x: torch.Tensor, groups: list, copy: bool) -> torch.Tensor:
    """The sum over ``groups`` in turn, added in f32 and rounded once to
    ``x``'s dtype; ``copy=False`` lets an f32 ``x`` be reduced in place."""
    acc = x.to(torch.float32, copy=copy)
    for g in groups:
        dist.all_reduce(acc, group=g)
    return acc.to(x.dtype)


class _ReduceFromGroups(torch.autograd.Function):
    """Megatron's ``g``: the sum of the ranks' partials forward; backward,
    every rank's gradient is the whole one (what follows is the same on
    every rank), so it passes as it is."""

    @staticmethod
    def forward(ctx, x, groups):
        return _sum_f32(x, list(groups), copy=True)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroups(torch.autograd.Function):
    """Megatron's ``f``: the identity forward (``x`` is the same on every
    rank); backward, each rank holds the gradient of its own shard's use
    of ``x``, and their sum is ``x``'s."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, list(ctx.groups), copy=True), None


def all_reduce_partial(x: torch.Tensor, group) -> torch.Tensor:
    """Sum the ranks' partial results of a row-parallel product (or of the
    vocab-sharded embedding lookup) into the full one, in ``x``'s dtype:
    the partials are added in f32 and rounded once, so the sum does not
    depend on the backend (gloo's or NCCL's bf16 arithmetic) and, at tp=2,
    equals a bf16 add. ``group`` may be a tuple of groups (a Mixture-of-
    Experts partial over tp and ep): the f32 sum runs over each in turn and
    is rounded once at the end. Identity without a group. ``x`` is a
    temporary: an f32 ``x`` is reduced in place, unless it takes part in
    autograd, where this is Megatron's ``g`` (the gradient passes through
    unchanged)."""
    groups = _group_list(group)
    if not groups:
        return x
    if _differentiable(x):
        return _ReduceFromGroups.apply(x, tuple(groups))
    return _sum_f32(x, groups, copy=False)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``, put where a tensor that is the same on every rank
    of ``group`` (a tuple of groups: each in turn) enters a sharded
    product: the identity forward, the sum of the ranks' gradients
    backward (f32, rounded once). ``x`` itself outside autograd."""
    groups = _group_list(group)
    if not groups or not _differentiable(x):
        return x
    return _CopyToGroups.apply(x, tuple(groups))


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _ALL_GATHER(out, x.contiguous(), group=group)
    shape = list(x.shape)
    shape[dim] *= n
    return out.view(n, *x.shape).movedim(0, dim).reshape(shape)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``group``."""
    n = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n)


def all_gather_cat(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (the
    column-parallel lm_head's vocabulary, a head-sharded pool's heads).
    Identity without a group. Outside autograd: training keeps the logits
    sharded (``transformer._token_losses``); ``gather_from_group`` is the
    differentiable gather."""
    if group is None:
        return x
    return _gather(x, group, dim % x.dim())


class _GatherFromGroup(torch.autograd.Function):
    """The blocks gathered forward; backward, every rank holds the whole
    gradient of a loss it computed whole, and keeps its own block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.group, ctx.dim).contiguous(), None, None


class _SplitToGroup(torch.autograd.Function):
    """A replicated tensor cut to the rank's block forward; backward, the
    blocks' gradients gathered, so every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.dim), None, None


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``all_gather_cat`` under autograd for a loss that every rank of
    ``group`` computes whole from the gathered tensor: the backward keeps
    the rank's block of the gradient (the loss counts once, not once per
    rank). Identity without a group."""
    if group is None:
        return x
    dim = dim % x.dim()
    if _differentiable(x):
        return _GatherFromGroup.apply(x, group, dim)
    return _gather(x, group, dim)


def split_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's contiguous block of a tensor replicated over ``group``
    (a tensor of its own); under autograd its backward gathers the blocks'
    gradients, the transpose of ``gather_from_group``. Identity without a
    group."""
    if group is None:
        return x
    dim = dim % x.dim()
    if _differentiable(x):
        return _SplitToGroup.apply(x, group, dim)
    return _block(x, group, dim).contiguous()


def reduce_scatter_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of every rank's ``x`` (f32, rounded once to ``x``'s dtype),
    and of it this rank's block along ``dim``: NCCL's
    ``reduce_scatter_tensor``; gloo has none, so there it is an
    all-reduce and the rank's slice (the same f32 sum, the same bits; the
    transport's choice, not the math's)."""
    if dist.get_backend(group) == "gloo":
        acc = _sum_f32(x, [group], copy=True)
        return _block(acc, group, dim).contiguous()
    n = dist.get_world_size(group)
    src = x.to(torch.float32).movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous().to(x.dtype)


class _GatherShards(torch.autograd.Function):
    """The fsdp gather: the shards concatenated forward; backward, every
    rank's gradient of the whole tensor is partial (its own batch rows),
    so they are summed and the rank keeps its block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_cat(grad, ctx.group, ctx.dim), None, None


def gather_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The whole of a tensor sharded along ``dim`` over ``group`` (a tuple
    of groups: the last one's shards innermost, so ``(dp, fsdp)`` gives the
    dp-major order of ``batch_shard_of``), on every rank. Under autograd its
    backward reduce-scatters the ranks' gradients: an fsdp weight's
    gradient summed over the ranks' batch shards, a batch-sharded
    tensor's gradient summed over every rank's use of it. Identity without
    a group."""
    dim = dim % x.dim()
    for g in reversed(_group_list(group)):
        x = (_GatherShards.apply(x, g, dim) if _differentiable(x)
             else _gather(x, g, dim))
    return x


def reduce_gradients(pairs, groups: MeshGroups) -> None:
    """After a backward under a mesh: each ``(leaf, spec)``'s gradient
    summed over the axes it is whole on whose ranks each hold a share of
    the loss: ``dp``, ``sp`` (a rank's positions), and ``fsdp`` unless
    ``spec`` shards the leaf over it (``gather_shards``' backward summed
    those). Not over ``pp``: a stage's layers live on it alone, and every
    stage computes the replicated embedding's and head's whole gradient
    from the same loss. A ``ColumnSpec`` leaf's columns are first summed
    over their copies on the ranks of its axis (each copy's gradient is a
    share of the column's). In f32, rounded once, in place; every rank then
    holds the same bits."""
    for leaf, spec in pairs:
        group = (getattr(groups, spec.axis) if isinstance(spec, ColumnSpec)
                 else None)
        if group is not None and leaf.grad is not None:
            leaf.grad.copy_(_sum_column_copies(leaf.grad, spec, group))
        gs = [g for g in (groups.dp, groups.sp,
                          None if "fsdp" in spec else groups.fsdp)
              if g is not None]
        if gs and leaf.grad is not None:
            total = _sum_f32(leaf.grad, gs, copy=False)
            if total is not leaf.grad:
                leaf.grad.copy_(total)


def _sum_column_copies(grad: torch.Tensor, spec: ColumnSpec,
                       group) -> torch.Tensor:
    """Every column of ``grad`` (the rank's columns of ``spec``) replaced by
    the sum of its copies' gradients over ``group``, in f32: each rank adds
    its columns into the whole width, the ranks' wholes are summed, and
    each takes its columns back."""
    cols = spec.columns[group_rank(group)].to(grad.device)
    whole = grad.new_zeros((*grad.shape[:-1], spec.whole), dtype=torch.float32)
    whole.index_add_(-1, cols, grad.float())
    dist.all_reduce(whole, group=group)
    return whole.index_select(-1, cols).to(grad.dtype)


# the one-tensor all-gather into a rank-major concatenation along dim 0;
# newer PyTorch renames all_gather_into_tensor and deprecates the old name
_ALL_GATHER = getattr(dist, "all_gather_single", None) or (
    dist.all_gather_into_tensor)


# ------------------------------------------ sequence-parallel exchanges
#
# gloo stages the CUDA tensors of its all_reduce, all_gather, all_to_all and
# broadcast through host memory itself (scripts/torch-tp-collectives.py
# records what it takes). Its send/recv hand the tensor's pointer to the
# transport as it is, so ``ring_shift`` stages CUDA tensors through host
# buffers itself on gloo (the transport of ranks that share one card); NCCL
# takes them as they are.


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as a point-to-point exchange takes it: contiguous, and on the
    host for a CUDA tensor on a gloo group."""
    if _staged(x, group):
        return x.detach().to("cpu").contiguous()
    return x.contiguous()


def ring_shift(tensors, group) -> list[torch.Tensor]:
    """Each tensor sent to the next rank of ``group`` and the previous
    rank's received in its place: the counterpart of ``lax.ppermute`` with
    ``perm=[(i, (i + 1) % n)]``. The sends and receives are posted
    together (``batch_isend_irecv``), so no rank blocks in a send while its
    neighbour does the same. Identity without a group or with one rank."""
    tensors = list(tensors)
    n = group_size(group)
    if n == 1:
        return tensors
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    sends = [_wire(t, group) for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def send_to(x: torch.Tensor, peer: int, group) -> None:
    """``x`` sent to rank ``peer`` of ``group`` (an index within it),
    blocking until the transport has it; staged through host memory for a
    CUDA tensor on gloo, as ``ring_shift`` does. The pipeline's stage-to-
    stage exchange: every send meets one ``recv_from`` on the peer."""
    dist.send(_wire(x, group), dist.get_global_rank(group, peer), group=group)


def recv_from(like: torch.Tensor, peer: int, group) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device received from rank
    ``peer`` of ``group``."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _staged(like, group) else like.device)
    dist.recv(buf, dist.get_global_rank(group, peer), group=group)
    return buf.to(like.device)


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"dim {split_dim} of {tuple(x.shape)} does not split {n} ways"
        )
    blocks = torch.stack(x.chunk(n, dim=split_dim))  # [n, *block]
    recv = torch.empty_like(blocks)
    dist.all_to_all_single(recv, blocks, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its transpose is the same exchange with the
    split and concatenated dims swapped."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad.contiguous(), *ctx.args), None, None, None


def all_to_all_tiled(x: torch.Tensor, group, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """The counterpart of ``lax.all_to_all(x, split_axis, concat_axis,
    tiled=True)``: ``x`` is cut into ``n`` blocks along ``split_dim``, block
    j goes to rank j of ``group``, and the blocks received are concatenated
    along ``concat_dim`` in the senders' rank order. Differentiable: the
    backward is the inverse exchange. Identity without a group."""
    n = group_size(group)
    if n == 1:
        return x
    split_dim %= x.dim()
    concat_dim %= x.dim()
    if _differentiable(x):
        return _AllToAll.apply(x, group, split_dim, concat_dim)
    return _all_to_all(x, group, split_dim, concat_dim)


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of rank ``src`` of ``group`` (an index within the group) on
    every rank; the others' ``x`` gives the shape and dtype. Identity
    without a group."""
    if group_size(group) == 1:
        return x
    buf = x.detach().clone().contiguous()
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return buf


# ---------------------------------------------------------------- launcher


# a spawned rank still running this many seconds (at most half its timeout)
# before its timeout writes the stack of every thread to its stacks file,
# which the parent's timeout error then carries: where a hung run stands
_STACKS_GRACE_S = 30.0


def _stacks_path(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"stacks-{rank}")


def _rank_main(fn, rank, world, init_method, device_type, backend, timeout_s,
               args, conn, tmp) -> None:
    """One spawned rank: join the group, run ``fn(rank, *args)``, send
    back ``("ok", pickled result)`` or ``("error", traceback)``. A barrier
    on each side of ``fn`` keeps a fast rank from tearing the group down
    while another still connects to it or still exchanges with it (gloo
    reports that as the other rank's failure); after a failure the parent
    stops the ranks left waiting."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    stacks = open(_stacks_path(tmp, rank), "w")
    faulthandler.dump_traceback_later(
        timeout_s - min(_STACKS_GRACE_S, timeout_s / 2), file=stacks)
    try:
        if device_type == "cuda":
            _set_local_device(rank)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        dist.barrier()
        result = fn(rank, *args)
        dist.barrier()
        # plain pickle: a tensor travels as its bytes, not as a shared-memory
        # handle that dies with this process
        conn.send(("ok", pickle.dumps(result)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        faulthandler.cancel_dump_traceback_later()
        stacks.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def spawn(fn, world: int, *, device_type: str = "cuda",
          backend: str | None = None, args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on ``world`` fresh ranks and return their
    results, in rank order. Each rank is a process of the ``spawn`` start
    method (CUDA may already be initialised here) that joins a group over
    a ``file://`` rendezvous in a temporary directory (no port to pick);
    on CUDA rank r takes card r modulo the visible cards. ``fn`` must be
    importable by name and its result picklable (CPU tensors, numpy).

    A rank that raises, or the whole run passing ``timeout`` seconds,
    stops every rank and raises RuntimeError with the first traceback (on
    a timeout, the stacks of the ranks still running). Not
    needed to use the API: under ``torchrun`` the ranks join through
    ``initialize_distributed``."""
    import torch.multiprocessing as mp

    _check_device_type(device_type)
    backend = backend or default_backend(device_type)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bci-spawn-") as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs, conns = [], []
        for rank in range(world):
            parent, child = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_rank_main,
                args=(fn, rank, world, init_method, device_type, backend,
                      timeout, args, child, tmp),
                daemon=True,
            )
            proc.start()
            child.close()
            procs.append(proc)
            conns.append(parent)
        results: dict[int, object] = {}
        error = None
        try:
            deadline = time.monotonic() + timeout
            waiting = dict(enumerate(conns))
            while waiting and error is None:
                ready = multiprocessing.connection.wait(
                    list(waiting.values()), timeout=max(0.0, deadline - time.monotonic())
                )
                if not ready:
                    error = f"ranks {sorted(waiting)} passed {timeout} s"
                    for rank in sorted(waiting):
                        path = _stacks_path(tmp, rank)
                        if os.path.exists(path):
                            with open(path) as f:
                                error += f"\nrank {rank}'s stacks:\n{f.read()}"
                    break
                for conn in ready:
                    rank = next(r for r, c in waiting.items() if c is conn)
                    del waiting[rank]
                    try:
                        status, payload = conn.recv()
                    except EOFError:
                        status, payload = "error", (
                            f"rank {rank} exited with code "
                            f"{procs[rank].exitcode} before it reported")
                    if status != "ok":
                        error = f"rank {rank} failed:\n{payload}"
                        break
                    results[rank] = pickle.loads(payload)
        finally:
            for proc in procs:
                proc.join(timeout=0 if error else 30)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            for conn in conns:
                conn.close()
    if error is not None:
        raise RuntimeError(error)
    return [results[r] for r in range(world)]
