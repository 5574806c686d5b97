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
restore onto another mesh or world raises ValueError.

Over a pipeline axis (``pp``) each stage holds its own block of the layers
under the same paths (``params["layers"][0]`` is stage s's first layer).
The save finds those blocks in the specs (a list in the state against one
layer's specs, for every layer: ``param_specs``' ``layers``) and records
each block's global layer index, so a stage's file holds its layers at
their global indices, the counterpart of orbax saving the stacked,
pp-sharded layers. A restore reads the layers it needs: onto a template of
another pp size each rank takes its new block, onto no mesh (or another
mesh without pp) every layer comes back in order.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from bee_code_interpreter_tpu_torch.parallel.mesh import (
    ColumnSpec,
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


def _layer_blocks(state, specs, mesh) -> list:
    """Under a pp mesh, ``[path, start, total]`` of every stage block in
    ``state``: a list against one layer's specs (a dict, for every layer),
    holding layers ``start .. start + len - 1`` of ``total``, the stage's
    contiguous block (``parallel.pipeline.stage_block``). Empty without
    pp."""
    stages = axis_sizes(mesh).get("pp", 1)
    if stages == 1:
        return []
    stage = axis_index(mesh, "pp")
    out = []

    def visit(tree, spec, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, spec.get(k) if isinstance(spec, dict) else None,
                      (*path, k))
        elif isinstance(tree, (list, tuple)):
            if isinstance(spec, dict):
                out.append([list(path), stage * len(tree),
                            stages * len(tree)])
            elif isinstance(spec, (list, tuple)) and not _is_spec(spec):
                for i, v in enumerate(tree):
                    visit(v, spec[i] if i < len(spec) else None, (*path, i))

    visit(state, specs, ())
    return out


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
        if sharded and isinstance(spec, ColumnSpec):
            shape = (*_whole_shape(x.shape[:-1], spec[:-1], axis_sizes(mesh)),
                     spec.whole)
        elif sharded:
            shape = _whole_shape(x.shape, spec, axis_sizes(mesh))
        return Abstract(
            shape=shape if sharded else tuple(x.shape),
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
        folder = self.directory / str(step)
        folder.mkdir(exist_ok=True)
        coords = {a: axis_index(mesh, a) for a in axis_sizes(mesh)}
        # a ColumnSpec leaf is saved as its plain spec's even block
        state = _map(lambda x, spec: spec.even_block(x.detach(), mesh)
                     if isinstance(spec, ColumnSpec)
                     and isinstance(x, torch.Tensor) else x, state, specs)
        flat_specs = _map(lambda x, spec: tuple(spec) if _is_spec(spec)
                          else None, state, specs)
        devices = _map(lambda x, _: str(x.device)
                       if isinstance(x, torch.Tensor) else None, state)
        rank = dist.get_rank()
        _durable_write(folder / f"rank-{rank}.pt", {
            "state": state, "specs": flat_specs, "devices": devices,
            "coords": coords, "axes": axis_sizes(mesh),
            "layer_blocks": _layer_blocks(state, specs, mesh)})
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
    """A sharded step as ``template`` lays it out (without one, as the
    whole tree: every saved layer of a pp save in order): a leaf saved with
    a spec put together from the overlapping parts of the saved shards, the
    block of this rank's new spec or the whole tensor on the host; a leaf
    saved without one this rank's own."""
    n = torch.load(folder / _COMPLETE, weights_only=True)["ranks"]
    files = [torch.load(folder / f"rank-{r}.pt", map_location="cpu",
                        mmap=True, weights_only=True) for r in range(n)]
    axes = files[0]["axes"]
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    # stage blocks: path -> (each file's first global layer, the total)
    blocks = {tuple(path): total for path, _, total
              in files[0].get("layer_blocks", [])}
    starts = [{tuple(path): start for path, start, _
               in f.get("layer_blocks", [])} for f in files]

    def locate(r, gpath):
        """``gpath`` (global layer indices) in file r, or None when the
        file's stage does not hold that layer."""
        out = list(gpath)
        for i in range(len(gpath) - 1):
            prefix = tuple(gpath[:i + 1])
            if prefix in blocks:
                local = gpath[i + 1] - starts[r][prefix]
                if not 0 <= local < len(_get(files[r]["state"], prefix)):
                    return None
                out[i + 1] = local
        return tuple(out)

    def to_global(path, tree):
        """A template path with its stage blocks' local indices made
        global (the template's stage block on its pp mesh)."""
        out = list(path)
        for i in range(len(path) - 1):
            prefix = tuple(path[:i + 1])
            if prefix in blocks and template is not None:
                block = _get(tree, prefix)
                mesh = next((a.mesh for a in _abstracts(block)), None)
                if mesh is not None and axis_sizes(mesh).get("pp", 1) > 1:
                    out[i + 1] += axis_index(mesh, "pp") * len(block)
        return tuple(out)

    def holders(gpath):
        found = [(r, loc) for r in range(n)
                 if (loc := locate(r, gpath)) is not None]
        if not found:
            raise ValueError(f"checkpoint holds no leaf "
                             f"{'.'.join(map(str, gpath))}")
        return found

    def own(path, gpath, mesh):
        saved_on = files[rank]["coords"] if rank < n else None
        loc = locate(rank, gpath) if rank < n else None
        if loc is None or n != world or (mesh is not None and (
                axis_sizes(mesh) != axes or saved_on != {
                    a: axis_index(mesh, a) for a in axis_sizes(mesh)})):
            raise ValueError(
                f"checkpoint leaf {'.'.join(map(str, path))} was saved "
                f"without a spec by one of {n} ranks over {axes}: it "
                f"restores only onto that mesh, not onto {world} ranks"
                + (f" over {axis_sizes(mesh)}" if mesh is not None else ""))
        leaf = _get(files[rank]["state"], loc)
        return leaf.detach().to(_get(files[rank]["devices"], loc))

    def assemble(found, spec, want: list[range]):
        out = None
        done = set()
        for r, loc in found:
            f = files[r]
            block = _get(f["state"], loc)
            have = _block_range(_whole_shape(block.shape, spec, axes), spec,
                                axes, f["coords"])
            key = tuple((x.start, x.stop) for x in have)
            if key in done:  # a replica of a block already copied
                continue
            done.add(key)
            lap = [range(max(w.start, h.start), min(w.stop, h.stop))
                   for w, h in zip(want, have)]
            if out is None:
                out = torch.empty([len(w) for w in want], dtype=block.dtype)
            if any(len(x) == 0 for x in lap):
                continue
            out[tuple(slice(x.start - w.start, x.stop - w.start)
                      for x, w in zip(lap, want))] = block.detach()[tuple(
                          slice(x.start - h.start, x.stop - h.start)
                          for x, h in zip(lap, have))]
        return out

    tree = _whole_layout(files, blocks, starts) if template is None else (
        template)

    def leaf(path, abstract):
        gpath = to_global(path, tree)
        found = holders(gpath)
        r0, loc0 = found[0]
        saved = _get(files[r0]["state"], loc0)
        if not isinstance(saved, torch.Tensor):
            return saved
        spec = _get(files[r0]["specs"], loc0)
        mesh = abstract.mesh if isinstance(abstract, Abstract) else None
        if spec is None:
            out = own(path, gpath, mesh)
        else:
            whole = _whole_shape(saved.shape, spec, axes)
            if isinstance(abstract, Abstract) and abstract.spec is not None:
                if whole != abstract.shape or saved.dtype != abstract.dtype:
                    raise ValueError(
                        f"checkpoint leaf {whole} {saved.dtype} does not "
                        f"match its template {abstract.shape} "
                        f"{abstract.dtype}")
                sizes = axis_sizes(mesh)
                coords = {a: axis_index(mesh, a) for a in sizes}
                if isinstance(abstract.spec, ColumnSpec):
                    # the whole last dim, then the rank's columns of it
                    out = assemble(found, spec, _block_range(
                        whole[:-1], abstract.spec[:-1], sizes, coords)
                        + [range(whole[-1])])
                    out = out.index_select(-1, abstract.spec.cols(mesh))
                else:
                    out = assemble(found, spec, _block_range(
                        whole, abstract.spec, sizes, coords))
                out = out.to(mesh.device_type)
            else:
                out = assemble(found, spec, [range(m) for m in whole])
        trains = (abstract.requires_grad if isinstance(abstract, Abstract)
                  else saved.requires_grad)
        return out.requires_grad_(trains)

    return _walk(leaf, tree)


def _abstracts(tree) -> list:
    """The ``Abstract`` leaves of a template subtree."""
    if isinstance(tree, Abstract):
        return [tree]
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _abstracts(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _abstracts(v)]
    return []


def _whole_layout(files: list, blocks: dict, starts: list) -> Any:
    """The saved tree's layout with every stage block made whole: its
    ``total`` layers in global order, each taken from the file whose
    stage holds it (the layout rank 0 saved without pp)."""
    def build(path):
        if path in blocks:
            layers = []
            for i in range(blocks[path]):
                r = next(r for r, st in enumerate(starts)
                         if 0 <= i - st[path] < len(_get(files[r]["state"],
                                                         path)))
                layers.append(_get(files[r]["state"], path)[i - starts[r][path]])
            return layers
        node = _get(files[0]["state"], path)
        if isinstance(node, dict):
            return {k: build((*path, k)) for k in node}
        if isinstance(node, (list, tuple)):
            out = [build((*path, i)) for i in range(len(node))]
            return type(node)(out) if isinstance(node, tuple) else out
        return node

    return build(())


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
