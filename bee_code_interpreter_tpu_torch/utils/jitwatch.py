"""First-call-per-signature wrappers over the batcher's programs: the port's
counterpart of ``bee_code_interpreter_tpu/utils/jitwatch.py``.

The JAX batcher's programs are ``jax.jit``-ed, and a call at a new (shape,
dtype) signature stalls for an XLA compilation. The port compiles nothing
per shape, but the first call of a program at a new signature still stalls
on the card: cuBLAS picks its algorithms for the new shapes, the caching
allocator grows, and in a cold process the first launch of a hand-written
kernel builds it with ``nvcc`` and loads it (``ops/cuda_build.py``).
:class:`TrackedJit` reports each such first call to a duck-typed monitor (an
``observability.DeviceMonitor``, or anything with an ``on_compile`` hook):
the function's name, the abstract signature of the call, the call's wall
time, and whether it was the function's first signature (``first_call``) or
a later one (``retrace``).

It is the JAX module's fallback path, the signature set: every monitored
call renders its abstract signature, and a signature not seen before is one
event. Signatures render as JAX renders them (``float32[4]``, not
``torch.float32[4]``), so the same traffic names the same shapes in both
packages. Once CUDA graphs capture these programs, a capture is the event
to report here.

Stdlib only (tensors and arrays are duck-typed through ``shape``/``dtype``/
``nbytes``), so ``models/`` uses it without importing ``observability/``.
"""

from __future__ import annotations

import time
from typing import Callable

# Containers with more leaves than this are summarized (leaf count + total
# bytes) instead of spelled out: a params tree has hundreds of leaves, and
# the cause of a new signature is a positional tensor, not the weights.
_MAX_SPELLED_LEAVES = 4


def _iter_leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _iter_leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _iter_leaves(v)
    else:
        yield x


def _dtype_name(dtype) -> str:
    """``float32`` for ``torch.float32`` as for numpy's and JAX's dtypes."""
    name = getattr(dtype, "name", None)
    if isinstance(name, str):
        return name
    return str(dtype).removeprefix("torch.")


def _leaf_signature(x) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        dims = ",".join(str(int(d)) for d in shape)
        return f"{_dtype_name(dtype)}[{dims}]"
    if x is None or isinstance(x, (bool, int, float, str)):
        # a static argument: its value is part of the signature
        return repr(x)
    return type(x).__name__


def _signature(x) -> str:
    if isinstance(x, (dict, list, tuple)):
        leaves = list(_iter_leaves(x))
        if len(leaves) > _MAX_SPELLED_LEAVES:
            nbytes = sum(int(getattr(leaf, "nbytes", 0) or 0) for leaf in leaves)
            return f"{type(x).__name__}[{len(leaves)} leaves, {nbytes}B]"
        inner = ", ".join(_leaf_signature(leaf) for leaf in leaves)
        return f"{type(x).__name__}({inner})"
    return _leaf_signature(x)


def abstract_signature(args: tuple, kwargs: dict | None = None) -> str:
    """The abstract input signature of a call: ``dtype[shape]`` per tensor
    or array, ``repr`` for statics, a summary for large containers."""
    parts = [_signature(a) for a in args]
    if kwargs:
        parts += [f"{k}={_signature(v)}" for k, v in sorted(kwargs.items())]
    return f"({', '.join(parts)})"


class TrackedJit:
    """Wrap a program so a monitor sees the first call at each signature.

    ``get_monitor`` is a zero-arg callable returning the current monitor
    (or None); resolving it per call keeps the wrapper attach/detach-safe
    and makes the unmonitored path one call plus one None check. Attribute
    access passes through to the wrapped callable.
    """

    __slots__ = ("fn", "name", "_get_monitor", "_signatures")

    def __init__(self, fn, name: str, get_monitor: Callable) -> None:
        self.fn = fn
        self.name = name
        self._get_monitor = get_monitor
        # the signatures of the calls made while monitored
        self._signatures: set[str] = set()

    def __getattr__(self, item):
        return getattr(self.fn, item)

    def __call__(self, *args, **kwargs):
        monitor = self._get_monitor()
        if monitor is None:
            return self.fn(*args, **kwargs)
        t0 = time.monotonic()
        out = self.fn(*args, **kwargs)
        duration_ms = (time.monotonic() - t0) * 1000.0
        signature = abstract_signature(args, kwargs)
        if signature in self._signatures:
            return out
        trigger = "first_call" if not self._signatures else "retrace"
        self._signatures.add(signature)
        # the call's wall time on the host, where a kernel build, cuBLAS's
        # algorithm choice and the allocator's growth happen: the stall the
        # caller felt (device work still queued is not in it)
        monitor.on_compile(
            self.name,
            signature=signature,
            duration_ms=duration_ms,
            trigger=trigger,
        )
        return out
