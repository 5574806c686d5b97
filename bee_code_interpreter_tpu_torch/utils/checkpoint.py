"""Step-indexed training-state checkpoints, the counterpart of
``bee_code_interpreter_tpu/utils/checkpoint.py`` (orbax there).

The state is any tree of dicts, lists and tensors, e.g. ``{"params":
params, "opt_state": optimizer.state_dict()}``; it is written with
``torch.save`` as ``<directory>/<step>.pt`` and read back with
``torch.load(weights_only=True)``, so a restore never runs code from the
file. Tensors come back on the device they were saved from, with their
``requires_grad``. A save is durable when it returns: the file is written
under a temporary name, fsynced, renamed over its final name and the
directory fsynced, so a crash leaves either the whole checkpoint or none.
``keep_last`` bounds the disk while keeping a recent resume point.

Under a mesh (``save(step, state, mesh=..., specs=...)``) the save is
sharded, as orbax's is: each rank writes its own shards, with each leaf's
spec and device and the rank's coordinates, to
``<directory>/<step>/rank-<r>.pt``, and once every rank has written (a
barrier) rank 0 marks the step complete. No rank gathers the whole state
(an 8B model's optimizer state would not fit one host), and every rank
writes at once. ``restore(template=...)`` with a template from
``abstract_like(state, mesh, specs)`` reshards onto that template's mesh,
which may be another topology with more or fewer ranks: the files are
opened lazily (``mmap``), and each rank copies out of the saved shards
only the parts that overlap the block its new spec gives it. A leaf saved
without a spec is the rank's own (an optimizer's state of its shards,
say): it comes back only to the same rank of the same mesh, and a
restore onto another mesh or world raises ValueError. A mesh with a
pipeline axis is refused (``NotImplementedError``): its ranks hold
different layers under the same paths, which the specs do not tell apart.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from bee_code_interpreter_tpu_torch.parallel.mesh import (
    axis_index,
    axis_sizes,
    shard_tensor,
)

_COMPLETE = "complete"


@dataclasses.dataclass(frozen=True)
class Abstract:
    """A leaf of ``abstract_like``'s template: the whole tensor's shape and
    dtype, whether it trains, the mesh it restores onto, and, to restore
    sharded, its spec there (a tuple of axis names per dim, as
    ``transformer.param_specs``)."""

    shape: tuple
    dtype: torch.dtype
    requires_grad: bool = False
    spec: tuple | None = None
    mesh: Any = None


def _map(fn, tree, other=None):
    """``fn(leaf, other's leaf)`` over the leaves of a tree of dicts,
    lists and tuples; ``other`` (a tree of the same layout, or None) may
    stop short, giving None below, and a dict of it against a list stands
    for every element (``param_specs``' one layer for every layer)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, other.get(k) if isinstance(other, dict)
                        else None) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if isinstance(other, dict):  # one layer's specs, for every layer
            seq = [other] * len(tree)
        elif isinstance(other, (list, tuple)) and not _is_spec(other):
            seq = other
        else:
            seq = ()
        out = [_map(fn, v, seq[i] if i < len(seq) else None)
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, other)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _whole_shape(shape, spec, sizes: dict) -> tuple:
    """The whole tensor's shape from one shard's, its spec and the mesh's
    axis sizes."""
    return tuple(n * (sizes.get(a, 1) if a else 1)
                 for n, a in zip(shape, list(spec) + [None] * len(shape)))


def abstract_like(state: Any, mesh=None, specs: Any = None) -> Any:
    """The template of ``state`` for ``TrainCheckpointer.restore``: each
    tensor an ``Abstract`` of its whole shape and dtype. With ``mesh`` and
    ``specs`` (a tree of the same layout as ``state``, e.g.
    ``transformer.param_specs`` under ``{"params": ...}``; a subtree may be
    missing) ``state`` holds this rank's shards under them, and each leaf
    with a spec restores as its shard on ``mesh``: restoring onto another
    topology takes a template made there. Other leaves restore as they were
    saved (a leaf of a sharded save without a spec only onto ``mesh`` as it
    was saved)."""
    def leaf(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        sharded = mesh is not None and _is_spec(spec)
        return Abstract(
            shape=(_whole_shape(x.shape, spec, axis_sizes(mesh)) if sharded
                   else tuple(x.shape)),
            dtype=x.dtype, requires_grad=x.requires_grad,
            spec=spec if sharded else None, mesh=mesh)

    return _map(leaf, state, specs if mesh is not None else None)


class TrainCheckpointer:
    """>>> ckpt = TrainCheckpointer(workdir / "ckpt")
    >>> ckpt.save(step, {"params": params, "opt_state": opt.state_dict()})
    >>> state = ckpt.restore()
    """

    def __init__(self, directory: str | Path, keep_last: int = 3) -> None:
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def save(self, step: int, state: Any, mesh=None,
             specs: Any = None) -> None:
        """Write ``state`` as ``step`` and return once it is durable on
        disk; then drop all but the newest ``keep_last`` steps. With
        ``mesh`` every rank of it calls this with its shards and ``specs``
        (``abstract_like``'s): the sharded save of the module docstring."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        if mesh is None:
            _durable_write(self._path(step), state)
            _fsync_dir(self.directory)
            self._prune()
            return
        if axis_sizes(mesh).get("pp", 1) > 1:
            raise NotImplementedError(
                "a sharded save over a pp mesh is not ported yet (ROADMAP "
                "Queue 1, item 1, slice 13): each stage's layers sit at the "
                "same paths")
        folder = self.directory / str(step)
        folder.mkdir(exist_ok=True)
        coords = {a: axis_index(mesh, a) for a in axis_sizes(mesh)}
        flat_specs = _map(lambda x, spec: spec if _is_spec(spec) else None,
                          state, specs)
        devices = _map(lambda x, _: str(x.device)
                       if isinstance(x, torch.Tensor) else None, state)
        rank = dist.get_rank()
        _durable_write(folder / f"rank-{rank}.pt", {
            "state": state, "specs": flat_specs, "devices": devices,
            "coords": coords, "axes": axis_sizes(mesh)})
        _fsync_dir(folder)
        dist.barrier()
        if rank == 0:
            _durable_write(folder / _COMPLETE, {"ranks": dist.get_world_size()})
            _fsync_dir(folder)
            self._prune()
        dist.barrier()

    def _prune(self) -> None:
        for old in self.all_steps()[: -self.keep_last]:
            self._path(old).unlink(missing_ok=True)
            folder = self.directory / str(old)
            if folder.is_dir():
                (folder / _COMPLETE).unlink(missing_ok=True)
                for f in folder.iterdir():
                    f.unlink()
                folder.rmdir()

    def restore(self, step: int | None = None, template: Any = None) -> Any:
        """Load ``step`` (default: the latest); raises ``FileNotFoundError``
        when there is none. ``template`` (``abstract_like``'s) puts each
        leaf with a spec on its mesh as this rank's shard, whatever the
        topology it was saved from, and gives the tree's layout; without it
        a sharded step's sharded leaves come back whole, on the host."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.directory}"
                )
        folder = self.directory / str(step)
        if (folder / _COMPLETE).exists():
            return _restore_sharded(folder, template)
        path = self._path(step)
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint for step {step} at {path}")
        state = torch.load(path, weights_only=True)
        return state if template is None else _map(_place, state, template)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        """Every complete step: single files and sharded folders."""
        files = {int(p.stem) for p in self.directory.glob("*.pt")
                 if p.stem.isdigit()}
        folders = {int(p.name) for p in self.directory.iterdir()
                   if p.name.isdigit() and (p / _COMPLETE).exists()}
        return sorted(files | folders)

    def close(self) -> None:
        """Nothing stays open between calls (every save is durable when it
        returns); kept so callers close it as they close the JAX one."""

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _walk(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of a tree of dicts, lists and
    tuples (an ``Abstract`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_walk(fn, v, (*path, i)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(path, tree)


def _block_range(shape, spec, sizes: dict, coords: dict) -> list[range]:
    """Along each dim of a whole tensor of ``shape``, the range of the
    block that ``coords`` hold under ``spec`` (``shard_tensor``'s
    layout)."""
    out = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        parts = sizes.get(axis, 1) if axis else 1
        m = n // parts
        start = coords[axis] * m if parts > 1 else 0
        out.append(range(start, start + m))
    return out


def _restore_sharded(folder: Path, template: Any) -> Any:
    """A sharded step as ``template`` lays it out (without one, as rank 0
    saved it): a leaf saved with a spec put together from the overlapping
    parts of the saved shards, the block of this rank's new spec or the
    whole tensor on the host; a leaf saved without one this rank's own."""
    n = torch.load(folder / _COMPLETE, weights_only=True)["ranks"]
    files = [torch.load(folder / f"rank-{r}.pt", map_location="cpu",
                        mmap=True, weights_only=True) for r in range(n)]
    axes = files[0]["axes"]
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1

    def own(path, mesh):
        saved_on = files[rank]["coords"] if rank < n else None
        if n != world or (mesh is not None and (
                axis_sizes(mesh) != axes or saved_on != {
                    a: axis_index(mesh, a) for a in axis_sizes(mesh)})):
            raise ValueError(
                f"checkpoint leaf {'.'.join(map(str, path))} was saved "
                f"without a spec by one of {n} ranks over {axes}: it "
                f"restores only onto that mesh, not onto {world} ranks"
                + (f" over {axis_sizes(mesh)}" if mesh is not None else ""))
        leaf = _get(files[rank]["state"], path)
        return leaf.detach().to(_get(files[rank]["devices"], path))

    def assemble(path, spec, want: list[range]):
        out = None
        done = set()
        for f in files:
            block = _get(f["state"], path)
            have = _block_range(_whole_shape(block.shape, spec, axes), spec,
                                axes, f["coords"])
            key = tuple((r.start, r.stop) for r in have)
            if key in done:  # a replica of a block already copied
                continue
            done.add(key)
            lap = [range(max(w.start, h.start), min(w.stop, h.stop))
                   for w, h in zip(want, have)]
            if out is None:
                out = torch.empty([len(w) for w in want], dtype=block.dtype)
            if any(len(r) == 0 for r in lap):
                continue
            out[tuple(slice(r.start - w.start, r.stop - w.start)
                      for r, w in zip(lap, want))] = block.detach()[tuple(
                          slice(r.start - h.start, r.stop - h.start)
                          for r, h in zip(lap, have))]
        return out

    def leaf(path, abstract):
        saved = _get(files[0]["state"], path)
        if not isinstance(saved, torch.Tensor):
            return saved
        spec = _get(files[0]["specs"], path)
        mesh = abstract.mesh if isinstance(abstract, Abstract) else None
        if spec is None:
            out = own(path, mesh)
        else:
            whole = _whole_shape(saved.shape, spec, axes)
            if isinstance(abstract, Abstract) and abstract.spec is not None:
                if whole != abstract.shape or saved.dtype != abstract.dtype:
                    raise ValueError(
                        f"checkpoint leaf {whole} {saved.dtype} does not "
                        f"match its template {abstract.shape} "
                        f"{abstract.dtype}")
                sizes = axis_sizes(mesh)
                out = assemble(path, spec, _block_range(
                    whole, abstract.spec, sizes,
                    {a: axis_index(mesh, a) for a in sizes}))
                out = out.to(mesh.device_type)
            else:
                out = assemble(path, spec, [range(m) for m in whole])
        trains = (abstract.requires_grad if isinstance(abstract, Abstract)
                  else saved.requires_grad)
        return out.requires_grad_(trains)

    return _walk(leaf, files[0]["state"] if template is None else template)


def _place(leaf, abstract):
    """A restored leaf as its template says: this rank's shard on the
    template's mesh for a leaf with a spec, else as it was restored."""
    if not isinstance(abstract, Abstract) or not isinstance(leaf, torch.Tensor):
        return leaf
    if abstract.spec is None:
        return leaf
    if tuple(leaf.shape) != abstract.shape or leaf.dtype != abstract.dtype:
        raise ValueError(
            f"checkpoint leaf {tuple(leaf.shape)} {leaf.dtype} does not "
            f"match its template {abstract.shape} {abstract.dtype}")
    out = shard_tensor(leaf, abstract.spec, abstract.mesh,
                       abstract.mesh.device_type)
    return out.requires_grad_(abstract.requires_grad)


def _durable_write(path: Path, obj) -> None:
    """``torch.save`` under a temporary name, fsynced, renamed over
    ``path``."""
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _fsync_dir(directory: Path) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)  # the rename itself survives a crash
    finally:
        os.close(fd)
