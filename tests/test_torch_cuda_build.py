"""The port's kernel build (``ops/cuda_build.py``) on the CPU, without nvcc:
the library a kernel loads is keyed by its source, every header of ``csrc``
and the flags, and the nvcc command line targets sm_90a and names the
header directory."""

import pytest

from bee_code_interpreter_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "hopper.cuh"\n__global__ void k() {}\n')
    (src / "other.cu").write_text("__global__ void other() {}\n")
    (src / "hopper.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(cuda_build, "CSRC", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    return src


@pytest.mark.parametrize("edit", ["hopper.cuh", "k.cu", "extra.cuh", "extra.h"])
def test_editing_the_source_or_a_header_rebuilds(csrc, edit):
    kernel = cuda_build.CudaKernel("k", {})
    before = kernel.library_path
    path = csrc / edit
    path.write_text((path.read_text() if path.exists() else "") + "// edited\n")
    after = kernel.library_path
    assert after != before
    assert after.parent == cuda_build.BUILD_DIR and after.name.startswith("k-")


@pytest.mark.parametrize("edit", ["other.cu", "notes.txt", "gen.py"])
def test_editing_an_unrelated_file_keeps_the_library(csrc, edit):
    kernel = cuda_build.CudaKernel("k", {})
    before = kernel.library_path
    (csrc / edit).write_text("// unrelated\n")
    assert kernel.library_path == before


def test_the_key_is_stable_and_per_kernel(csrc):
    a, b = cuda_build.CudaKernel("k", {}), cuda_build.CudaKernel("other", {})
    assert a.library_path == cuda_build.CudaKernel("k", {}).library_path
    assert a.library_path != b.library_path


def test_nvcc_command_targets_sm90a_and_names_the_headers(csrc, tmp_path):
    kernel = cuda_build.CudaKernel("k", {})
    out = tmp_path / "k.so"
    cmd = kernel.nvcc_command("nvcc", out)
    assert cmd[0] == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert f"-I{csrc}" in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert cmd[-1] == str(csrc / "k.cu")
    assert "-shared" in cmd and "-Xptxas=-v" in cmd


@pytest.mark.parametrize(
    "name", ["flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "paged_decode"])
def test_the_repo_kernels_include_the_shared_header(name):
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    assert '#include "hopper.cuh"' in src
    # products and copies go through hopper.cuh
    for instr in ("wgmma.mma_async", "mma.sync", "cp.async.bulk", "ldmatrix.sync"):
        assert instr not in src
    header = (cuda_build.CSRC / "hopper.cuh").read_text()
    for instr in ("wgmma.mma_async", "mma.sync", "ldmatrix.sync",
                  "cp.async.bulk.tensor", "cp.async.bulk.shared::cluster.global",
                  "mbarrier.try_wait", "setmaxnreg"):
        assert instr in header
