"""The port's ``models/lora.py`` against the JAX package's, on the same
weights and adapters (tiny config, f32): shapes of ``init_lora``, the
zero-init identity, ``merge_lora`` within 1e-6, three steps of
``make_lora_train_step`` (losses and factors) with a frozen base,
``stack_lora_bank`` and ``lora_param_count``, and the same validation
errors. Checklist: the JAX package's tests/test_lora.py (its ViT case waits
for the vision family)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import lora as jax_lora
from bee_code_interpreter_tpu.models import transformer as jax_t
from bee_code_interpreter_tpu_torch.models import lora as torch_lora
from bee_code_interpreter_tpu_torch.models import transformer as torch_t

from tests.torch_parity import lora_to_torch, tiny_configs, tiny_params


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


def nonzero_adapter(jcfg, seed, targets=("wq", "wv"), rank=4):
    """A JAX adapter whose B is drawn non-zero (init_lora's B = 0 would
    make every comparison trivial)."""
    lora = jax_lora.init_lora(jcfg, jax.random.PRNGKey(seed), rank=rank,
                              targets=targets)
    return {t: {"A": ab["A"],
                "B": jax.random.normal(jax.random.PRNGKey(seed + 100),
                                       ab["B"].shape) * 0.25}
            for t, ab in lora.items()}


def token_batch(seed, B=4, L=16):
    seq = np.random.default_rng(seed).integers(0, 256, (B, L + 1))
    return ({"tokens": jnp.asarray(seq[:, :-1]), "targets": jnp.asarray(seq[:, 1:])},
            {"tokens": torch.as_tensor(seq[:, :-1]),
             "targets": torch.as_tensor(seq[:, 1:])})


def test_init_lora_layout_matches_jax(models):
    jcfg, tcfg, _, _ = models
    targets = ("wq", "wk", "wo", "w_down")
    jl = jax_lora.init_lora(jcfg, jax.random.PRNGKey(1), rank=4, targets=targets)
    tl = torch_lora.init_lora(tcfg, torch.Generator().manual_seed(1), rank=4,
                              targets=targets)
    assert set(tl) == set(jl)
    for t in targets:
        for k in ("A", "B"):
            assert tuple(tl[t][k].shape) == jl[t][k].shape
            assert tl[t][k].dtype == torch.float32
        assert not tl[t]["B"].any()
    # A is gaussian / sqrt(d_in)
    a = tl["w_down"]["A"]
    assert abs(a.std().item() * np.sqrt(a.shape[1]) - 1.0) < 0.1
    assert torch_lora.lora_param_count(tl) == jax_lora.lora_param_count(jl)
    assert torch_lora.DEFAULT_TARGETS == jax_lora.DEFAULT_TARGETS


def test_init_lora_from_layers_reads_concrete_params_like_jax(models):
    """Shapes come off concrete layers in both frameworks (the JAX stacked
    pytree, the port's per-layer dicts): the same targets and shapes."""
    _, _, jparams, tparams = models
    targets = ("wv", "w_up")
    jl = jax_lora.init_lora_from_layers(jparams["layers"], jax.random.PRNGKey(2),
                                        rank=3, targets=targets)
    tl = torch_lora.init_lora_from_layers(tparams["layers"],
                                          torch.Generator().manual_seed(2),
                                          rank=3, targets=targets)
    assert {t: {k: tuple(x.shape) for k, x in ab.items()} for t, ab in tl.items()} \
        == {t: {k: x.shape for k, x in ab.items()} for t, ab in jl.items()}
    with pytest.raises(ValueError, match="no LoRA target"):
        torch_lora.init_lora_from_layers(tparams["layers"], torch.Generator(),
                                         targets=("ln1",))


def test_zero_init_is_identity(models):
    _, tcfg, _, tparams = models
    lora = torch_lora.init_lora(tcfg, torch.Generator().manual_seed(1), rank=4)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 16)))
    base = torch_t.forward(tparams, tokens, tcfg)
    merged = torch_t.forward(torch_lora.merge_lora(tparams, lora), tokens, tcfg)
    assert torch.equal(base, merged)


def test_merge_lora_matches_jax(models):
    jcfg, tcfg, jparams, tparams = models
    jl = nonzero_adapter(jcfg, 3, targets=("wq", "wk", "wv", "wo"))
    jm = jax_lora.merge_lora(jparams, jl, 2.0)
    tm = torch_lora.merge_lora(tparams, lora_to_torch(jl), 2.0)
    for i, layer in enumerate(tm["layers"]):
        for name, leaf in layer.items():
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(jm["layers"][name][i]),
                                       rtol=1e-6, atol=1e-6)
        assert layer["w_up"] is tparams["layers"][i]["w_up"]  # untouched
    tokens = np.random.default_rng(4).integers(0, 256, (2, 12))
    want = np.asarray(jax_t.forward(jm, jnp.asarray(tokens), jcfg))
    got = torch_t.forward(tm, torch.as_tensor(tokens), tcfg).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_lora_train_step_matches_jax_and_freezes_base(models):
    """Three steps from the same factors: the same losses, the same factors
    after (AdamW with optax.adamw(1e-3)'s settings), the base untouched and
    without a gradient."""
    jcfg, tcfg, jparams, _ = models
    _, tparams = tiny_params(jcfg, tcfg, requires_grad=True)  # f32 masters
    base = [w.detach().clone() for w in torch_t.param_leaves(tparams)]
    jl = jax_lora.init_lora(jcfg, jax.random.PRNGKey(1), rank=4)
    tl = lora_to_torch(jl)
    jstep, jopt = jax_lora.make_lora_train_step(jcfg, scale=2.0)
    tstep, topt = torch_lora.make_lora_train_step(tcfg, scale=2.0)
    jstate, tstate = jopt.init(jl), topt(tl)
    jbatch, tbatch = token_batch(5)
    for _ in range(3):
        jl, jstate, jloss = jstep(jl, jstate, jparams, jbatch)
        tl, tstate, tloss = tstep(tl, tstate, tparams, tbatch)
        assert abs(tloss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for t in tl:
        for k in ("A", "B"):
            np.testing.assert_allclose(tl[t][k].detach().numpy(),
                                       np.asarray(jl[t][k]), rtol=1e-4,
                                       atol=1e-6)
    assert any(tl[t]["B"].abs().max() > 0 for t in tl)
    for w, before in zip(torch_t.param_leaves(tparams), base):
        assert torch.equal(w.detach(), before) and w.grad is None


def test_lora_training_decreases_loss(models):
    _, tcfg, _, tparams = models
    lora = torch_lora.init_lora(tcfg, torch.Generator().manual_seed(1), rank=4)
    step, optimizer = torch_lora.make_lora_train_step(tcfg)
    state = None
    _, batch = token_batch(6)
    losses = []
    for _ in range(8):
        lora, state, loss = step(lora, state, tparams, batch)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_param_count_is_small(models):
    _, tcfg, _, tparams = models
    n_base = torch_t.n_params(tparams)
    lora = torch_lora.init_lora(tcfg, torch.Generator().manual_seed(1), rank=4)
    assert torch_lora.lora_param_count(lora) < n_base * 0.05


def test_errors_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    errors = []
    for call in (
        lambda: jax_lora.init_lora(jcfg, jax.random.PRNGKey(0),
                                   targets=("w_nope",)),
        lambda: torch_lora.init_lora(tcfg, torch.Generator(),
                                     targets=("w_nope",)),
    ):
        with pytest.raises(ValueError, match="no LoRA target") as err:
            call()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    # a mesh is a DeviceMesh with axis names (training under one is held
    # to JAX in tests/test_torch_train_mesh.py)
    with pytest.raises(ValueError, match="DeviceMesh"):
        torch_lora.make_lora_train_step(tcfg, mesh=object())


def test_stack_lora_bank_matches_jax(models):
    jcfg, _, _, _ = models
    adapters = [nonzero_adapter(jcfg, s) for s in (7, 8)]
    jbank = jax_lora.stack_lora_bank(adapters)
    tbank = torch_lora.stack_lora_bank([lora_to_torch(a) for a in adapters])
    assert list(tbank) == list(jbank)
    for t in tbank:
        for k in ("A", "B"):
            assert np.array_equal(tbank[t][k].numpy(), np.asarray(jbank[t][k]))
            assert not tbank[t][k][:, 0].any()  # index 0: the base adapter

    def zeros(*shape):
        return (jnp.zeros(shape), torch.zeros(shape))

    def tree(i, spec):
        return {t: {"A": zeros(*a)[i], "B": zeros(*b)[i]}
                for t, (a, b) in spec.items()}

    bad = [
        ("share targets", [{"wq": ((2, 8, 2), (2, 2, 8))},
                           {"wv": ((2, 8, 2), (2, 2, 8))}]),
        ("disagree", [{"wq": ((2, 8, 2), (2, 2, 8))},
                      {"wq": ((2, 8, 4), (2, 4, 8))}]),
        ("at least one", []),
    ]
    for match, specs in bad:
        msgs = []
        for i, stack in enumerate((jax_lora.stack_lora_bank,
                                   torch_lora.stack_lora_bank)):
            with pytest.raises(ValueError, match=match) as err:
                stack([tree(i, s) for s in specs])
            msgs.append(str(err.value))
        if match != "disagree":  # shape sets print as tuples in both
            assert msgs[0] == msgs[1]


def test_merged_decode_consistency(models):
    """A merged adapter decodes the same through ``generate`` and
    ``generate_cached``, and as the JAX merged model does."""
    jcfg, tcfg, jparams, tparams = models
    jl = jax.tree.map(lambda x: x + 0.01,
                      jax_lora.init_lora(jcfg, jax.random.PRNGKey(1), rank=2))
    merged = torch_lora.merge_lora(tparams, lora_to_torch(jl))
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (1, 5)))
    model = torch_t.Transformer(tcfg)
    a = model.generate(merged, prompt, max_new_tokens=4)
    b = model.generate_cached(merged, prompt, max_new_tokens=4)
    assert torch.equal(a, b)
    want = jax_t.Transformer(jcfg).generate_cached(
        jax_lora.merge_lora(jparams, jl), jnp.asarray(prompt.numpy()),
        max_new_tokens=4)
    assert b.tolist() == np.asarray(want).tolist()


def test_merge_keeps_the_base_dtype(models):
    jcfg, tcfg, jparams, _ = models
    from bee_code_interpreter_tpu_torch.weights import params_from_jax

    bf16 = params_from_jax(jax.tree.map(np.asarray, jparams),
                           dataclasses.replace(tcfg, dtype=torch.bfloat16),
                           device="cpu")
    merged = torch_lora.merge_lora(bf16, lora_to_torch(nonzero_adapter(jcfg, 9)))
    assert merged["layers"][0]["wq"].dtype == torch.bfloat16
