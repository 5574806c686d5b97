"""On-demand ``torch.profiler`` captures: the port's counterpart of the
serving and device captures of
``bee_code_interpreter_tpu/observability/profiling.py``.

:class:`ServingProfiler` wraps anything with a ``step()`` (an ``Engine``, a
``ContinuousBatcher``, or a ``ServingMonitor`` attached to one) and captures
N steps under ``torch.profiler.profile``; :class:`DeviceProfiler` does the
same, or runs a small probe computation when nothing is attached. CUDA
activity (CUPTI) is traced when the stepper's batcher lives on a card. Each
capture writes a Chrome trace (``export_chrome_trace``) into a fresh
``tempfile.mkdtemp`` directory and returns the JAX dict: ``trace_dir``,
``files`` (relative to it), ``steps`` and ``duration_ms``.

A capture raises :class:`ProfilerUnavailable` when another one is running
(the profiler is process-global, and two captures would corrupt each
other), when the profiler cannot start, or when a capture of CUDA work
recorded no device activity (CUPTI could not trace). The sandbox-side
profile trigger of the JAX module (``inject_profile_env``,
``profile_artifacts``) belongs to the sandbox reroute, which is not ported.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from pathlib import Path

import torch


class ProfilerUnavailable(RuntimeError):
    """The profiler cannot capture here (or a capture is in progress)."""


def _stepper_device(stepper) -> torch.device | None:
    """The device of the batcher behind ``stepper``: a batcher, an engine
    (``.batcher``) or an attached ServingMonitor (``._batcher``)."""
    for batcher in (stepper, getattr(stepper, "batcher", None),
                    getattr(stepper, "_batcher", None)):
        device = getattr(batcher, "device", None)
        if isinstance(device, torch.device):
            return device
    return None


class _Capture:
    """The capture both profilers share: the one-at-a-time flag, the trace
    directory, ``torch.profiler`` around ``run`` and the returned dict."""

    def __init__(self, trace_root: str | Path | None, prefix: str) -> None:
        self._trace_root = str(trace_root) if trace_root else None
        self._prefix = prefix
        self._capturing = False
        self._lock = threading.Lock()

    @property
    def capturing(self) -> bool:
        return self._capturing

    def __call__(self, run, cuda: bool) -> dict:
        with self._lock:
            if self._capturing:
                raise ProfilerUnavailable("a capture is already in progress")
            self._capturing = True
        # every exit path resets the flag: a stuck True would refuse every
        # later capture until the process restarts
        try:
            trace_dir = tempfile.mkdtemp(prefix=self._prefix,
                                         dir=self._trace_root)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            t0 = time.monotonic()
            try:
                prof.__enter__()
            except Exception as e:
                # nothing was captured: leave no empty directory behind
                shutil.rmtree(trace_dir, ignore_errors=True)
                raise ProfilerUnavailable(
                    f"torch.profiler cannot trace here: {e}"
                ) from e
            try:
                run()
                if cuda:
                    torch.cuda.synchronize()
            finally:
                prof.__exit__(None, None, None)
            duration_ms = (time.monotonic() - t0) * 1000.0
            if cuda and not any(
                e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events()
            ):
                shutil.rmtree(trace_dir, ignore_errors=True)
                raise ProfilerUnavailable(
                    "torch.profiler recorded no CUDA activity (CUPTI "
                    "cannot trace here)"
                )
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        finally:
            self._capturing = False
        files = sorted(
            str(Path(root, name).relative_to(trace_dir))
            for root, _dirs, names in os.walk(trace_dir)
            for name in names
        )
        return {
            "trace_dir": trace_dir,
            "files": files,
            "duration_ms": duration_ms,
        }


class ServingProfiler:
    """Captures batcher or engine steps under ``torch.profiler``.

    ``stepper`` is anything with a ``step()`` method. Overlapping captures
    are refused (an atomic check-and-set under a lock).
    """

    def __init__(self, stepper, trace_root: str | Path | None = None) -> None:
        self._stepper = stepper
        self._capture = _Capture(trace_root, "bci-profile-")

    @property
    def capturing(self) -> bool:
        return self._capture.capturing

    @property
    def available(self) -> bool:
        """True when the stepper can step: a stepper may say so itself (a
        ServingMonitor is unavailable until an engine attaches)."""
        return bool(getattr(self._stepper, "available", True))

    def capture(self, steps: int) -> dict:
        """Run ``steps`` stepper steps under a profiler trace; returns
        ``{trace_dir, files, steps, duration_ms}``."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        device = _stepper_device(self._stepper)

        def run():
            for _ in range(steps):
                self._stepper.step()

        out = self._capture(
            run, cuda=device is not None and device.type == "cuda"
        )
        return {**out, "steps": steps}


class DeviceProfiler:
    """One on-demand trace of raw device activity. With an attached engine
    (``stepper.available``) the capture windows real batcher steps; without
    one it runs a small probe computation (on the card when there is one),
    so the timeline is never empty."""

    def __init__(self, stepper=None, trace_root: str | Path | None = None) -> None:
        self._stepper = stepper
        self._capture = _Capture(trace_root, "bci-device-profile-")

    @property
    def capturing(self) -> bool:
        return self._capture.capturing

    @property
    def available(self) -> bool:
        """``torch.profiler`` ships with PyTorch; whether it traces the card
        here is only knowable by trying (a capture raises
        ProfilerUnavailable)."""
        return True

    def capture(self, steps: int = 8) -> dict:
        """``steps`` engine steps when an engine is attached, a probe
        computation otherwise; the ``ServingProfiler.capture`` dict plus
        ``source`` = ``serving|probe``."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        stepped = bool(
            self._stepper is not None
            and getattr(self._stepper, "available", True)
        )
        if stepped:
            device = _stepper_device(self._stepper)
        else:
            device = torch.device(
                "cuda" if torch.cuda.is_available() else "cpu"
            )

        def run():
            if stepped:
                for _ in range(steps):
                    self._stepper.step()
                return
            x = torch.ones((256, 256), dtype=torch.float32, device=device)
            for _ in range(steps):
                x = x @ x / 256.0
            x.cpu()

        out = self._capture(
            run, cuda=device is not None and device.type == "cuda"
        )
        return {**out, "steps": steps,
                "source": "serving" if stepped else "probe"}
