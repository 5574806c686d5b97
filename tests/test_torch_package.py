"""Hygiene of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points refuse to fall back to the CPU on their own, and the weight
bridge keeps the JAX pytree's shapes."""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu_torch.models import serving as torch_serving
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.weights import params_from_jax

from tests.torch_parity import tiny_configs

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "bee_code_interpreter_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "bee_code_interpreter_tpu")


def imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def port_files() -> list[Path]:
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "scripts").glob("torch-*.py")))


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_jax_package_imports(path):
    """Matched by the top-level name, so the port's own package (whose name
    starts with the JAX package's) is allowed and the JAX package is not."""
    bad = sorted(m for m in imported_modules(path)
                 if m.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_hygiene_check_catches_the_jax_package(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import bee_code_interpreter_tpu_torch.ops\n"
                     "from bee_code_interpreter_tpu.ops import kv_cache\n")
    tops = {m.split(".")[0] for m in imported_modules(probe)}
    assert tops & set(FORBIDDEN) == {"bee_code_interpreter_tpu"}


def test_kernel_sources_exist_with_their_notes():
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "paged_decode"):
        src = (PORT / "ops" / "csrc" / f"{name}.cu").read_text()
        assert "Replaces the TPU kernel" in src and "Bound on this card" in src
        assert "cudaGetLastError" in src


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg = tiny_configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_t.init_params(tcfg, torch.Generator())
    params_np = jax.tree.map(
        np.asarray, jax_t.init_params(jcfg, jax.random.PRNGKey(0))
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(params_np, tcfg)
    cpu_params = params_from_jax(params_np, tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_serving.ContinuousBatcher(cpu_params, tcfg)
    # asked for explicitly, the CPU runs
    torch_serving.ContinuousBatcher(cpu_params, tcfg, device="cpu")


def test_params_from_jax_round_trips_shapes():
    jcfg, tcfg = tiny_configs()
    jparams = jax_t.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                             device="cpu", dtype=torch.bfloat16)
    assert len(params["layers"]) == jcfg.n_layers
    for name in ("embed", "ln_f", "lm_head"):
        assert tuple(params[name].shape) == jparams[name].shape
        assert params[name].dtype == torch.bfloat16
    for i, layer in enumerate(params["layers"]):
        for name, stacked in jparams["layers"].items():
            assert tuple(layer[name].shape) == stacked.shape[1:]
            want = torch.tensor(np.asarray(stacked[i])).to(torch.bfloat16)
            assert torch.equal(layer[name], want)


def test_params_from_jax_refuses_what_is_not_ported():
    """A dense config given an MoE tree, or the reverse, is a ValueError; a
    tiny_moe tree round-trips, leaf for leaf."""
    jcfg, tcfg = tiny_configs()
    params_np = jax.tree.map(
        np.asarray, jax_t.init_params(jcfg, jax.random.PRNGKey(0))
    )
    moe = {**params_np, "layers": {**params_np["layers"], "moe": {}}}
    with pytest.raises(ValueError, match="MoE"):
        params_from_jax(moe, tcfg, device="cpu")
    jmoe, tmoe = tiny_configs(n_experts=4)
    with pytest.raises(ValueError, match="MoE"):
        params_from_jax(params_np, tmoe, device="cpu")
    moe_np = jax.tree.map(np.asarray,
                          jax_t.init_params(jmoe, jax.random.PRNGKey(0)))
    params = params_from_jax(moe_np, tmoe, device="cpu")
    for i, layer in enumerate(params["layers"]):
        assert list(layer) == list(torch_t.layer_shapes(tmoe))
        for name, stacked in moe_np["layers"]["moe"].items():
            assert torch.equal(layer["moe"][name],
                               torch.from_numpy(np.array(stacked[i])))
    with pytest.raises(ValueError, match="experts"):
        params_from_jax(moe_np, dataclasses.replace(tmoe, n_experts=8),
                        device="cpu")
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(params_np, dataclasses.replace(tcfg, n_layers=3),
                        device="cpu")


def test_setuptools_finds_the_port_under_the_existing_glob():
    from setuptools import find_packages

    found = find_packages(where=str(REPO), include=["bee_code_interpreter_tpu*"])
    assert "bee_code_interpreter_tpu_torch" in found
    assert "bee_code_interpreter_tpu_torch.ops" in found
