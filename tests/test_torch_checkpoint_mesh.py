"""The port's sharded checkpoints (``utils/checkpoint.py``): the cases of
the JAX package's tests/test_checkpoint.py:39-80 on four gloo CPU ranks
(``tests/torch_train_worker.py::checkpoint_cases``, one spawn).

JAX saves over ``{"fsdp": 2, "tp": 4}`` and restores onto ``{"fsdp": 4,
"tp": 2}`` on 8 virtual devices; the 4-rank analogue saves over ``{"fsdp":
2, "tp": 2}`` (params after one train step, each rank its shards) and
restores onto ``{"fsdp": 1, "tp": 4}``: every leaf exact, and each the
new mesh's shard (``shard_params`` of the whole trained tree there). The
optimizer-state round trip saves params, AdamW state and a step count and
restores them bitwise on the same mesh; the optimizer state, saved
without specs, is refused onto another mesh. A second spawn saves on two
ranks (``{"tp": 2}``, after one train step), and the four ranks restore
its params onto ``{"fsdp": 2, "tp": 2}``, every leaf exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from tests import torch_train_worker as W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cfg = dataclasses.replace(jax_t.TransformerConfig.tiny(),
                              dtype=jnp.float32, z_loss=1e-2)
    params = jax_t.init_params(cfg, jax.random.PRNGKey(0))
    kv_cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=2)
    kv_params = jax_t.init_params(kv_cfg, jax.random.PRNGKey(4))
    seq = np.random.default_rng(6).integers(0, 256, (4, 33)).astype(np.int32)
    inputs = {"dense": jax.tree.map(np.asarray, params),
              W.KV_CASES["tp4_kv2"][1]: jax.tree.map(np.asarray, kv_params),
              "batch": {"tokens": seq[:, :-1], "targets": seq[:, 1:]}}
    directory = str(tmp_path_factory.mktemp("ckpt"))
    two_dir = str(tmp_path_factory.mktemp("ckpt_two"))
    two = M.spawn(W.checkpoint_two_ranks, 2, device_type="cpu",
                  args=(inputs, two_dir), timeout=300)
    return M.spawn(W.checkpoint_cases, 4, device_type="cpu",
                   args=(inputs, directory, {
                       "directory": two_dir,
                       "shards": [rec["shards"] for rec in two]}),
                   timeout=300)


def test_sharded_save_restores_exactly_onto_another_topology(ranks):
    for r, rec in enumerate(ranks):
        assert rec["steps"] == [1, 17], r
        assert rec["cross_exact"], r
        assert rec["cross_requires_grad"], r
        for got, want in rec["cross_shapes"]:
            assert got == want, r
        # without a template the sharded leaves come back whole
        assert rec["whole_shapes"] == rec["full_shapes"], r
        assert rec["coords_b"]["tp"] == r and rec["coords_b"]["fsdp"] == 0


def test_every_rank_puts_the_same_whole_tree_together(ranks):
    for rec in ranks[1:]:
        jax.tree.map(np.testing.assert_array_equal, rec["whole"],
                     ranks[0]["whole"])


def test_optimizer_state_round_trip(ranks):
    assert all(rec["same_mesh_exact"] for rec in ranks)


def test_restore_from_two_ranks_onto_four(ranks):
    """A world larger than the saving one: each rank copies the parts of
    the two saved shards its new block overlaps."""
    for r, rec in enumerate(ranks):
        assert rec["two_to_four_exact"], r
        assert rec["two_to_four_keys"] == ["params"], r


def test_spec_less_leaves_are_refused_onto_another_topology(ranks):
    """A leaf saved without a spec (AdamW's moments of the rank's shards)
    is the saving rank's own: onto another mesh of the same world, or onto
    more ranks, the restore raises rather than hand it to another block."""
    for rec in ranks:
        for what in ("other_mesh_refused", "two_to_four_opt_refused"):
            kind, msg = rec[what]
            assert kind == "ValueError", what
            assert "without a spec" in msg, what


def test_tp_not_dividing_kv_heads_restores_onto_another_mesh(ranks):
    """Saved at tp=4 over 2 K/V heads (``wk``/``wv`` a copy of one head on
    each rank, saved as the even column blocks of the whole leaf): restored
    whole, every leaf has its whole shape, and sharded back over tp=4 it is
    the trained params bitwise; restored onto dp=2 x tp=2 (tp divides the
    K/V heads there) each leaf is that mesh's shard of the whole, still
    trainable; restored onto the same mesh, the params bitwise."""
    for r, rec in enumerate(ranks):
        for what in ("kv_whole_shapes_ok", "kv_roundtrip_exact",
                     "kv_other_mesh_exact", "kv_same_mesh_exact", "kv_trains"):
            assert rec[what], (r, what)
