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

Not ported yet (the parallel layer, ROADMAP Queue 1):
``abstract_like`` and restoring onto another mesh.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch


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

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as ``step`` and return once it is durable on
        disk; then drop all but the newest ``keep_last`` steps."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        final = self._path(step)
        tmp = self.directory / f".{step}.pt.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            tmp.unlink(missing_ok=True)
        fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(fd)  # the rename itself survives a crash
        finally:
            os.close(fd)
        for old in self.all_steps()[: -self.keep_last]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, step: int | None = None) -> Any:
        """Load ``step`` (default: the latest); raises ``FileNotFoundError``
        when there is none."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.directory}"
                )
        path = self._path(step)
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint for step {step} at {path}")
        return torch.load(path, weights_only=True)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(p.stem) for p in self.directory.glob("*.pt")
                      if p.stem.isdigit())

    def close(self) -> None:
        """Nothing stays open between calls (every save is durable when it
        returns); kept so callers close it as they close the JAX one."""

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
