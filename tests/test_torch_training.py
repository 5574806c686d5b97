"""The port's training path against the JAX package's on the same weights
(tiny config, 2 KV heads, f32, ``z_loss=1e-2`` so the z-loss term shows):
``loss_fn``, every leaf's gradient, three AdamW steps of
``make_train_step``, and the checkpointer. Tolerances: 1e-5 on losses and
parameters, 1e-4 relative on gradients (f32 on both sides; XLA and PyTorch
sum in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.utils.checkpoint import TrainCheckpointer

from tests.torch_parity import tiny_configs, tiny_params, to_np

TOL = 1e-5
GRAD_TOL = 1e-4
LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down")


def configs(window=None):
    return tiny_configs(z_loss=1e-2, sliding_window=window)


def make_batch(seed=1, B=2, L=12):
    seq = np.random.default_rng(seed).integers(0, 256, (B, L + 1)).astype(np.int32)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


def torch_batch(batch):
    return {name: torch.from_numpy(x) for name, x in batch.items()}


def jax_batch(batch):
    return {name: jnp.asarray(x) for name, x in batch.items()}


def pairs(jtree, tparams):
    """(name, JAX leaf, port leaf) for every weight; JAX stacks layers."""
    for name in ("embed", "ln_f", "lm_head"):
        yield name, jtree[name], tparams[name]
    for i, layer in enumerate(tparams["layers"]):
        for name in LAYER_KEYS:
            yield f"layers.{i}.{name}", jtree["layers"][name][i], layer[name]


def test_loss_fn_matches_jax():
    jcfg, tcfg = configs()
    jparams, tparams = tiny_params(jcfg, tcfg)
    batch = make_batch()
    want = jax_t.loss_fn(jparams, jax_batch(batch), jcfg)
    got = torch_t.loss_fn(tparams, torch_batch(batch), tcfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), atol=TOL, rtol=TOL)
    # the z-loss term is part of it: the same weights without it differ
    plain = torch_t.loss_fn(tparams, torch_batch(batch),
                            dataclasses.replace(tcfg, z_loss=0.0))
    assert abs(plain.item() - got.item()) > 1e-3


def test_forward_return_aux_is_zero_for_dense():
    _, tcfg = configs()
    _, tparams = tiny_params(*configs())
    tokens = torch.from_numpy(make_batch()["tokens"])
    logits = torch_t.forward(tparams, tokens, tcfg)
    logits2, (k, v), aux = torch_t.forward(tparams, tokens, tcfg,
                                           return_kv=True, return_aux=True)
    assert torch.equal(logits, logits2) and k.shape[0] == tcfg.n_layers
    assert aux.dtype == torch.float32 and aux.item() == 0.0


@pytest.mark.parametrize("window", [None, 5])
def test_every_gradient_matches_jax_grad(window):
    jcfg, tcfg = configs(window)
    jparams, tparams = tiny_params(jcfg, tcfg, requires_grad=True)
    batch = make_batch(seed=2)
    want = jax.grad(jax_t.loss_fn)(jparams, jax_batch(batch), jcfg)
    loss = torch_t.loss_fn(tparams, torch_batch(batch), tcfg)
    loss.backward()
    for name, w, t in pairs(want, tparams):
        w = np.asarray(w)
        np.testing.assert_allclose(
            to_np(t.grad), w, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(w).max()), err_msg=name,
        )


def test_every_leaf_gets_a_finite_nonzero_gradient():
    jcfg, tcfg = configs()
    _, tparams = tiny_params(jcfg, tcfg, requires_grad=True)
    step = torch_t.Transformer(tcfg).make_train_step()
    step(tparams, None, torch_batch(make_batch()))
    leaves = torch_t.param_leaves(tparams)
    assert len(leaves) == 3 + 9 * tcfg.n_layers  # embed, ln_f, lm_head
    for leaf in leaves:
        assert leaf.grad is not None and leaf.grad.shape == leaf.shape
        assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().max() > 0


def test_three_train_steps_match_jax_make_train_step():
    jcfg, tcfg = configs()
    jparams, tparams = tiny_params(jcfg, tcfg, requires_grad=True)
    batch = make_batch(seed=3)
    jmodel = jax_t.Transformer(jcfg)
    jstep = jmodel.make_train_step()
    jstate = jmodel.make_optimizer().init(jparams)
    tmodel = torch_t.Transformer(tcfg)
    tstep = tmodel.make_train_step()
    tstate = None
    for i in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jax_batch(batch))
        tparams, tstate, tloss = tstep(tparams, tstate, torch_batch(batch))
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=TOL,
                                   rtol=TOL, err_msg=f"loss, step {i + 1}")
        for name, w, t in pairs(jparams, tparams):
            np.testing.assert_allclose(to_np(t), np.asarray(w), atol=TOL,
                                       rtol=TOL,
                                       err_msg=f"{name}, step {i + 1}")
    assert isinstance(tstate, torch.optim.AdamW)
    group = tstate.param_groups[0]
    assert group["betas"] == (0.9, 0.95) and group["weight_decay"] == 0.1
    assert group["lr"] == 3e-4 and group["eps"] == 1e-8


# -------------------------------------------------------------- checkpoints


def test_checkpointer_round_trip_and_retention(tmp_path):
    with TrainCheckpointer(tmp_path / "ckpt", keep_last=2) as ckpt:
        assert ckpt.latest_step() is None and ckpt.all_steps() == []
        states = {}
        for step in (1, 5, 3, 7):
            states[step] = {"w": torch.full((3,), float(step)),
                            "meta": {"step": step, "betas": (0.9, 0.95)}}
            ckpt.save(step, states[step])
        # the two newest steps are kept, counted by step number
        assert ckpt.all_steps() == [5, 7] and ckpt.latest_step() == 7
        assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
            "5.pt", "7.pt"]
        got = ckpt.restore()
        assert torch.equal(got["w"], states[7]["w"])
        assert got["meta"] == states[7]["meta"]
        assert torch.equal(ckpt.restore(5)["w"], states[5]["w"])
        with pytest.raises(FileNotFoundError):
            ckpt.restore(3)


def test_checkpointer_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TrainCheckpointer(tmp_path / "empty").restore()
    with pytest.raises(ValueError):
        TrainCheckpointer(tmp_path / "x", keep_last=0)


def test_resume_from_checkpoint_is_bitwise_equal_to_straight_run(tmp_path):
    """2 steps, save, restore into fresh objects, 2 more steps: the same
    bits as 4 straight steps (params, optimizer state and losses)."""
    jcfg, tcfg = configs()
    model = torch_t.Transformer(tcfg)
    step = model.make_train_step()
    batch = torch_batch(make_batch(seed=4))

    _, straight = tiny_params(jcfg, tcfg, requires_grad=True)
    state, straight_losses = None, []
    for _ in range(4):
        straight, state, loss = step(straight, state, batch)
        straight_losses.append(loss)

    _, params = tiny_params(jcfg, tcfg, requires_grad=True)
    opt, losses = None, []
    for _ in range(2):
        params, opt, loss = step(params, opt, batch)
        losses.append(loss)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(2, {"params": params, "opt_state": opt.state_dict()})
    del params, opt
    restored = ckpt.restore()
    params = restored["params"]
    assert all(w.requires_grad for w in torch_t.param_leaves(params))
    opt = model.make_optimizer()(params)
    opt.load_state_dict(restored["opt_state"])
    for _ in range(2):
        params, opt, loss = step(params, opt, batch)
        losses.append(loss)

    assert [x.item() for x in losses] == [x.item() for x in straight_losses]
    for a, b in zip(torch_t.param_leaves(params),
                    torch_t.param_leaves(straight)):
        assert torch.equal(a, b)
    for a, b in zip(opt.state.values(), state.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def test_moe_and_mesh_still_raise():
    jcfg, tcfg = configs()
    _, tparams = tiny_params(jcfg, tcfg)
    with pytest.raises(NotImplementedError):
        torch_t.Transformer(tcfg, mesh=object())
    moe = dataclasses.replace(tcfg, n_experts=4)
    with pytest.raises(NotImplementedError):
        torch_t.Transformer(moe).init(torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError):
        torch_t.loss_fn(tparams, torch_batch(make_batch()), moe)
