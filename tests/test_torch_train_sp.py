"""The port's training step under sequence parallelism against the JAX
package's ``make_train_step`` on the same mesh shapes.

The port's ranks are spawned with gloo on the CPU, once per world size (2
and 4), running ``tests/torch_train_worker.py::train_sp_cases``; JAX runs
here on the virtual CPU devices, a mesh over the first 2 or 4 of them,
its batch placed by ``batch_sharding()`` (``P(batch, "sp")``): a rank holds
its rows and, of them, its block of positions. The cases: sp=2 with the
ring and with Ulysses, dp=2 x sp=2, sp=2 x tp=2 (the vocab-parallel loss
kept), MoE under sp=2 and under dp=2 x sp=2 (one routing group of the
128 tokens, spanning the batch and the sequence shards: the ranks route
the tokens JAX routes together, at capacity factor 0.5, so choices are
dropped), and the LoRA step at sp=2 x tp=2 (tests/test_models.py:49's
and tests/test_lora.py's JAX steps on an sp mesh). Each runs four steps
in f32 and is held as tests/test_torch_train_mesh.py holds its meshes:
losses and updated leaves within 1e-5, first gradients within 1e-4 of
the leaf's largest, replicas bitwise.
"""

import numpy as np
import pytest

from bee_code_interpreter_tpu_torch.parallel import mesh as M
from tests import torch_train_worker as W
from tests.test_torch_train_mesh import (  # noqa: F401 - inputs: the fixture
    assert_lora_matches_jax,
    assert_matches_jax,
    inputs,
)


@pytest.fixture(scope="module")
def spawned(inputs):
    payload = {k: inputs[k] for k in ("dense", "moe", "lora", "lora_scale",
                                      "batch")}
    return {world: M.spawn(W.train_sp_cases, world, device_type="cpu",
                           args=(world, payload), timeout=600)
            for world in (2, 4)}


@pytest.mark.parametrize("case", list(W.SP_CASES))
def test_train_step_under_sp_matches_jax(case, spawned, inputs):
    axes, which = W.SP_CASES[case]
    assert_matches_jax(spawned[W.world_of(axes)], case, axes, which, inputs)


def test_each_rank_trains_on_its_block(spawned):
    """The rows split over dp, the positions over sp."""
    for case, (axes, _) in W.SP_CASES.items():
        for rec in spawned[W.world_of(axes)]:
            assert rec[case]["rows"] == 4 // axes.get("dp", 1), case
            assert rec[case]["positions"] == 32 // axes["sp"], case


def test_lora_train_step_under_sp_matches_jax(spawned, inputs):
    assert_lora_matches_jax(spawned[4], "lora_sp2_tp2", {"sp": 2, "tp": 2},
                            inputs)


def test_sp_loss_is_the_global_batch_on_every_rank(spawned):
    """Each rank's loss is the whole batch's, counted once: ring and
    Ulysses agree on it within the f32 tolerance."""
    ring = spawned[2][0]["sp2_ring"]["losses"]
    uly = spawned[2][0]["sp2_ulysses"]["losses"]
    np.testing.assert_allclose(ring, uly, atol=1e-5, rtol=1e-5)
