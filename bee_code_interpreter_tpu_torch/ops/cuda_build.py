"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on its
own with ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so``, where the
hash covers the source, every header of ``csrc`` (``*.cuh``, ``*.h``: the
Hopper building blocks in ``hopper.cuh``) and the flags, so an edited source
or header rebuilds. The library is loaded with ``ctypes``; every C entry
point returns the ``cudaError_t`` of its launch and ``CudaKernel.launch``
raises when it is not 0.

Nothing here runs at import: the CPU test suite imports every module and
has no ``nvcc``. A build happens at the first launch of a
kernel, or all at once through ``build_all`` (``chip_smoke.py``), which
starts one ``nvcc`` per source in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _headers() -> list[Path]:
    """The headers a kernel source may include, in a fixed order."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cuh", ".h"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels build only "
            "on a machine with the CUDA toolkit"
        )
    return found


class CudaKernel:
    """One ``csrc/<name>.cu`` library: its build, its loaded handle, and
    the count of kernel launches its wrapper made (``launches``)."""

    def __init__(self, name: str, signatures: dict[str, list]) -> None:
        self.name = name
        self.source = CSRC / f"{name}.cu"
        # C function name -> ctypes argtypes; every restype is c_int
        self.signatures = signatures
        self.launches = 0
        self._lib: ctypes.CDLL | None = None

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in _headers():
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def nvcc_command(self, nvcc: str, out: Path) -> list[str]:
        """The command line with which compiler ``nvcc`` builds this source
        into ``out``."""
        return [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(out),
                str(self.source)]

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source unless its library exists;
        returns the process (None when already built)."""
        out = self.library_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        try:
            proc = subprocess.Popen(
                self.nvcc_command(_nvcc(), tmp), stdout=log, stderr=subprocess.STDOUT,
            )
        finally:
            log.close()
        proc.tmp_path = tmp  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        rc = proc.wait()
        log = self.library_path.with_suffix(".log")
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name} (rc {rc}):\n"
                + log.read_text()
            )
        os.replace(proc.tmp_path, self.library_path)

    def build_log(self) -> str:
        """What nvcc printed for the current build (ptxas register and
        shared-memory use), or '' when this process did not build it."""
        log = self.library_path.with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call C entry point ``fn`` and count the launch; raises if the
        launch reported a CUDA error."""
        err = getattr(self.lib(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err}")
        self.launches += 1


def build_all(kernels: list[CudaKernel]) -> None:
    """Build every kernel's library, one nvcc per source, all in parallel,
    then load each."""
    procs = [(k, k.start_build()) for k in kernels]
    failures = []
    for k, proc in procs:  # wait for every nvcc before reporting any failure
        try:
            k.finish_build(proc)
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    for k in kernels:
        k.lib()
