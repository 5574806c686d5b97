"""The port's ViT (``bee_code_interpreter_tpu_torch/models/vit.py``) against
the JAX package's ``models/vit.py`` on the same weights and inputs.

``ViTConfig.tiny()`` in f32, images and labels from numpy seeds: the
forward logits (1e-4, tests/test_torch_training.py's forward limit), every
gradient of ``loss_fn`` against ``jax.grad`` (``GRAD_TOL``), one AdamW step
against ``optax.adamw(3e-4, weight_decay=0.05)`` (``TOL``), and ViT-B/16's
structure (JAX's ``test_vit_b16_structure``: 196 patches, ~86M parameters,
each leaf's shape, head dim 64). On four gloo CPU ranks
(``tests/torch_vision_worker.py::vit_cases``): dp=2 x tp=2, fsdp=2 x tp=2
and sp=4 by the ring and by Ulysses (JAX's ``tests/test_vit.py:38,77``
meshes) against the unsharded JAX forward (2e-4, those tests' limit), one
train step each against JAX's unsharded step (the loss within ``TOL``, the
rank's gradients after the sums over the batch axes and sp within
``GRAD_TOL`` and its shards within ``STEP_TOL`` of the same blocks of JAX's
gradients and updated leaves), and ``param_specs`` equal to JAX's (HWIO's ``patch_embed`` spec
turned OIHW, one layer's specs for JAX's stacked ones).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bee_code_interpreter_tpu.models import vit as jv
from bee_code_interpreter_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bee_code_interpreter_tpu_torch.models import vit as V
from bee_code_interpreter_tpu_torch.parallel import mesh as M
from bee_code_interpreter_tpu_torch.weights import vit_params_from_jax
from tests import torch_vision_worker as W

FWD_TOL = 1e-4
MESH_FWD_TOL = 2e-4
TOL = 1e-5
# gradients: tests/test_torch_training.py's GRAD_TOL (1e-4 of the leaf's
# largest element)
GRAD_TOL = 1e-4
# a leaf after one AdamW step from the gradients of a sharded loss: AdamW's
# first step moves a weight by ~lr * g / (|g| + eps), so a gradient element
# near f32 noise moves by a fraction of lr that differs between the two
# sums' orders (tests/test_torch_train_mesh.py's EXPERT_TOL, and its reason)
STEP_TOL = 0.1 * 3e-4


def jax_config(**kw):
    return dataclasses.replace(jv.ViTConfig.tiny(), dtype=jnp.float32, **kw)


def ohwi(x):
    """A JAX HWIO conv leaf in the port's OIHW layout."""
    return np.asarray(x).transpose(3, 2, 0, 1)


@pytest.fixture(scope="module")
def inputs():
    params = jv.init_params(jax_config(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {"images": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, 4).astype(np.int32)}
    return {"jax_params": params, "params": jax.tree.map(np.asarray, params),
            "batch": batch}


def port_params(inputs, requires_grad=False):
    return vit_params_from_jax(inputs["params"], W.vit_config(), device="cpu",
                               requires_grad=requires_grad)


def jax_tree_as_port(tree) -> list:
    """A JAX ViT tree's leaves in ``vit.param_leaves``' order and layout."""
    n = np.asarray(tree["layers"]["wq"]).shape[0]
    return ([ohwi(tree["patch_embed"]), np.asarray(tree["pos_embed"])]
            + [np.asarray(tree["layers"][k])[i] for i in range(n)
               for k in V.LAYER_KEYS]
            + [np.asarray(tree["ln_f"]), np.asarray(tree["head"]["w"]),
               np.asarray(tree["head"]["b"])])


def test_forward_matches_jax(inputs):
    images = inputs["batch"]["images"]
    want = np.asarray(jv.forward(inputs["jax_params"], jnp.asarray(images),
                                 jax_config()))
    got = V.forward(port_params(inputs), torch.as_tensor(images),
                    W.vit_config())
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


def test_gradients_match_jax(inputs):
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    loss, grads = jax.value_and_grad(jv.loss_fn)(inputs["jax_params"], batch,
                                                 jax_config())
    params = port_params(inputs, requires_grad=True)
    got = V.loss_fn(params, W.tensors(inputs["batch"]), W.vit_config())
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= TOL
    for w, g in zip(V.param_leaves(params), jax_tree_as_port(grads),
                    strict=True):
        scale = max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(w.grad.numpy(), g,
                                   atol=GRAD_TOL * scale, rtol=GRAD_TOL)


def test_adamw_step_matches_optax(inputs):
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    optimizer = optax.adamw(3e-4, weight_decay=0.05)
    params = inputs["jax_params"]
    loss, grads = jax.value_and_grad(jv.loss_fn)(params, batch, jax_config())
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    want = optax.apply_updates(params, updates)
    model = V.ViT(W.vit_config())
    got, _, got_loss = model.make_train_step()(
        port_params(inputs, requires_grad=True), None,
        W.tensors(inputs["batch"]))
    assert abs(float(got_loss) - float(loss)) <= TOL
    for w, x in zip(V.param_leaves(got), jax_tree_as_port(want), strict=True):
        np.testing.assert_allclose(w.detach().numpy(), x, atol=TOL, rtol=TOL)


def test_vit_b16_structure():
    config = V.ViTConfig.vit_b16()
    assert config.n_patches == 196 and config.head_dim == 64
    jax_shapes = jax.eval_shape(lambda k: jv.init_params(jv.ViTConfig(), k),
                                jax.random.PRNGKey(0))
    shapes = V.param_shapes(config)
    n = (sum(int(np.prod(s)) for k, s in shapes.items()
             if k not in ("layers", "head"))
         + config.n_layers * sum(int(np.prod(s))
                                 for s in shapes["layers"].values())
         + sum(int(np.prod(s)) for s in shapes["head"].values()))
    assert 85_000_000 < n < 88_000_000, n
    assert n == sum(int(np.prod(x.shape)) for x in
                    jax.tree.leaves(jax_shapes))
    hwio = jax_shapes["patch_embed"].shape
    assert shapes["patch_embed"] == (hwio[3], hwio[2], hwio[0], hwio[1])
    for k, s in shapes["layers"].items():
        assert (config.n_layers, *s) == jax_shapes["layers"][k].shape, k
    assert shapes["head"]["w"] == jax_shapes["head"]["w"].shape


# ---------------------------------------------------------------- meshes


@pytest.fixture(scope="module")
def spawned(inputs):
    payload = {k: inputs[k] for k in ("params", "batch")}
    return M.spawn(W.vit_cases, 4, device_type="cpu", args=(payload,),
                   timeout=600)


def jax_specs_as_port(axes):
    """JAX's ``param_specs`` on a mesh of ``axes``, in the port's
    convention: tuples of axis names, one layer's for the stacked layers,
    ``patch_embed``'s turned OIHW."""
    mesh = jax_make_mesh(axes, devices=jax.devices()[:4])
    specs = jv.param_specs(jax_config(), mesh)

    def spec(p):
        return tuple(p)

    pe = spec(specs["patch_embed"])
    return {"patch_embed": (pe[3], pe[2], pe[0], pe[1]),
            "pos_embed": spec(specs["pos_embed"]),
            "layers": {k: spec(v)[1:] for k, v in specs["layers"].items()},
            "ln_f": spec(specs["ln_f"]),
            "head": {k: spec(v) for k, v in specs["head"].items()}}


def strip(spec):
    """A spec without its trailing Nones (JAX writes ``P(None)`` where the
    port writes ``()``)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def rank_rows(x, coords, axes):
    """The rows of a global batch rank ``coords`` holds: dp then fsdp."""
    index, count = 0, 1
    for a in ("dp", "fsdp"):
        n = axes.get(a, 1)
        index, count = index * n + coords.get(a, 0), count * n
    rows = x.shape[0] // count
    return x[index * rows:(index + 1) * rows]


def block(x, spec, coords, axes):
    """The block of whole leaf ``x`` that ``coords`` hold under ``spec``."""
    for d, a in enumerate(spec):
        if a is None or axes.get(a, 1) == 1:
            continue
        n = x.shape[d] // axes[a]
        x = np.take(x, range(coords[a] * n, (coords[a] + 1) * n), axis=d)
    return x


@pytest.fixture(scope="module")
def jax_step(inputs):
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    optimizer = optax.adamw(3e-4, weight_decay=0.05)
    params = inputs["jax_params"]
    loss, grads = jax.value_and_grad(jv.loss_fn)(params, batch, jax_config())
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    return (float(loss), jax_tree_as_port(optax.apply_updates(params, updates)),
            jax_tree_as_port(grads))


@pytest.mark.parametrize("case", list(W.VIT_CASES))
def test_mesh_forward_matches_unsharded_jax(spawned, inputs, case):
    images = jnp.asarray(inputs["batch"]["images"])
    want = np.asarray(jv.forward(inputs["jax_params"], images, jax_config()))
    axes = W.VIT_CASES[case][0]
    for rec in spawned:
        got = rec[case]
        np.testing.assert_allclose(
            got["logits"], rank_rows(want, got["coords"], axes),
            atol=MESH_FWD_TOL, rtol=MESH_FWD_TOL)


@pytest.mark.parametrize("case", list(W.VIT_CASES))
def test_mesh_train_step_matches_unsharded_jax(spawned, jax_step, case):
    loss, want, grads = jax_step
    axes = W.VIT_CASES[case][0]
    for rec in spawned:
        got = rec[case]
        assert abs(got["loss"] - loss) <= TOL
        pairs = V.leaf_specs(got["params"], got["specs"])
        # the gradients after the sums over the batch axes and sp: AdamW's
        # first step hides a gradient's scale, so they are held too
        for g, (_, spec), x in zip(got["grads"], pairs, grads, strict=True):
            want_g = block(x, spec, got["coords"], axes)
            scale = max(np.abs(want_g).max(), 1e-30)
            np.testing.assert_allclose(g, want_g, atol=GRAD_TOL * scale,
                                       rtol=GRAD_TOL)
        for (w, spec), x in zip(pairs, want, strict=True):
            np.testing.assert_allclose(
                w, block(x, spec, got["coords"], axes), atol=STEP_TOL,
                rtol=STEP_TOL)


@pytest.mark.parametrize("case", list(W.VIT_CASES))
def test_param_specs_equal_jax(spawned, case):
    want = jax_specs_as_port(W.VIT_CASES[case][0])
    got = spawned[0][case]["specs"]
    for key in ("patch_embed", "pos_embed", "ln_f"):
        assert strip(got[key]) == strip(want[key]), key
    for k in V.LAYER_KEYS:
        assert strip(got["layers"][k]) == strip(want["layers"][k]), k
    for k in ("w", "b"):
        assert strip(got["head"][k]) == strip(want["head"][k]), k
