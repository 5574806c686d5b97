"""The port's HF Llama loader (``models/hf_loader.py``) against two oracles:
``transformers.LlamaForCausalLM`` built in memory from a ``LlamaConfig``
(no download), logits within 1e-4 in f32, and the JAX package's
``load_llama_params``, leaf for leaf. Checklist: the JAX package's
tests/test_hf_loader.py, every case."""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bee_code_interpreter_tpu.models import hf_loader as jax_hf
from bee_code_interpreter_tpu_torch.models import transformer as torch_t
from bee_code_interpreter_tpu_torch.models.hf_loader import (
    config_from_hf,
    load_llama_params,
)
from bee_code_interpreter_tpu_torch.models.serving import ContinuousBatcher

from tests.torch_parity import to_np

transformers = pytest.importorskip("transformers")

LOGIT_TOL = 1e-4
TOKENS = np.array([[5, 3, 7, 2, 9, 4, 1, 8, 100, 200, 17, 42],
                   [1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144]],
                  dtype=np.int64)
LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down")


def tiny_hf(tie=False, **kw):
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False, attention_dropout=0.0,
        tie_word_embeddings=tie, **kw,
    )
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def hf_logits(model):
    with torch.no_grad():
        return model(torch.from_numpy(TOKENS)).logits.numpy()


def ours(model):
    params, config = load_llama_params(model, dtype=torch.float32,
                                       device="cpu")
    return to_np(torch_t.forward(params, torch.from_numpy(TOKENS), config))


@pytest.mark.parametrize("tie", [False, True])
def test_logits_parity_with_transformers(tie):
    """Untied, and tied embeddings (no ``lm_head.weight``: the head falls
    back to the embedding transposed)."""
    model = tiny_hf(tie=tie)
    assert ("lm_head.weight" in model.state_dict()) or tie
    np.testing.assert_allclose(ours(model), hf_logits(model), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_tied_embeddings_fall_back():
    model = tiny_hf(tie=True)
    sd = {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"}
    params, _ = load_llama_params(sd, model.config, dtype=torch.float32,
                                  device="cpu")
    assert torch.equal(params["lm_head"], params["embed"].t())
    assert params["lm_head"].data_ptr() != params["embed"].data_ptr()


@pytest.mark.parametrize("tie", [False, True])
def test_every_leaf_equals_jax_loader(tie):
    model = tiny_hf(tie=tie)
    jparams, jcfg = jax_hf.load_llama_params(model, dtype=jnp.float32)
    params, config = load_llama_params(model, dtype=torch.float32,
                                       device="cpu")
    fields = [f.name for f in dataclasses.fields(jcfg) if f.name != "dtype"]
    assert {f: getattr(config, f) for f in fields} == {
        f: getattr(jcfg, f) for f in fields}
    for name in ("embed", "ln_f", "lm_head"):
        np.testing.assert_array_equal(to_np(params[name]),
                                      np.asarray(jparams[name]))
    for i, layer in enumerate(params["layers"]):
        assert tuple(layer) == LAYER_KEYS
        for name in LAYER_KEYS:
            assert layer[name].is_contiguous()
            np.testing.assert_array_equal(
                to_np(layer[name]), np.asarray(jparams["layers"][name][i]))


def test_bf16_checkpoint_loads_bitwise():
    """A bf16 checkpoint into bf16 weights: every leaf is its source's bits
    (transposed), and the source tensors are not aliased."""
    model = tiny_hf().to(torch.bfloat16)
    sd = model.state_dict()
    params, config = load_llama_params(model, device="cpu")
    assert config.dtype == torch.bfloat16
    assert torch.equal(params["embed"], sd["model.embed_tokens.weight"])
    assert params["embed"].data_ptr() != sd["model.embed_tokens.weight"].data_ptr()
    assert torch.equal(params["lm_head"], sd["lm_head.weight"].t())
    for i, layer in enumerate(params["layers"]):
        assert all(w.dtype == torch.bfloat16 for w in layer.values())
        assert torch.equal(layer["wk"], sd[f"model.layers.{i}.self_attn.k_proj.weight"].t())
        assert torch.equal(layer["ln2"],
                           sd[f"model.layers.{i}.post_attention_layernorm.weight"])


def test_loaded_model_decodes_and_serves():
    """Cached greedy decode equals HF's greedy generation, and the paged
    batcher serves the same tokens."""
    model = tiny_hf()
    params, config = load_llama_params(model, dtype=torch.float32, device="cpu")
    prompt = TOKENS[0, :8]
    n = 6
    with torch.no_grad():
        hf_out = model.generate(
            torch.from_numpy(prompt[None, :]), max_new_tokens=n,
            do_sample=False, num_beams=1,
        )[0, len(prompt):].tolist()
    got = torch_t.Transformer(config).generate_cached(
        params, torch.from_numpy(prompt[None, :]), max_new_tokens=n)
    assert got[0, len(prompt):].tolist() == hf_out
    b = ContinuousBatcher(params, config, max_batch=2, n_pages=16,
                          page_size=4, max_pages_per_seq=8, device="cpu")
    r = b.submit(prompt.tolist(), n)
    b.run_to_completion()
    assert b.result(r) == hf_out


def test_config_mapping_and_refusals():
    model = tiny_hf()
    config = config_from_hf(model.config)
    assert (config.d_model, config.n_layers, config.n_heads,
            config.kv_heads, config.ff_dim) == (64, 2, 4, 2, 128)
    assert config.dtype == torch.bfloat16
    for kw, match in (
        (dict(rms_norm_eps=1e-6), "rms_norm_eps"),
        (dict(attention_bias=True), "attention_bias"),
        (dict(rope_scaling={"rope_type": "yarn", "factor": 4.0}),
         "rope_scaling"),
        (dict(hidden_act="gelu"), "hidden_act"),
        (dict(mlp_bias=True), "mlp_bias"),
        (dict(hidden_size=64, num_attention_heads=4, head_dim=32), "head_dim"),
    ):
        cfg = transformers.LlamaConfig(**{"rms_norm_eps": 1e-5, **kw})
        with pytest.raises(ValueError, match=match):
            config_from_hf(cfg)
        with pytest.raises(ValueError, match=match):
            jax_hf.config_from_hf(cfg)
    # a derived (or absent) head_dim still loads
    cfg = transformers.LlamaConfig(rms_norm_eps=1e-5, hidden_size=64,
                                   num_attention_heads=4, head_dim=16)
    assert config_from_hf(cfg).d_model == 64


def test_linear_rope_scaling_maps():
    model = tiny_hf(rope_scaling={"rope_type": "linear", "factor": 2.0})
    _, config = load_llama_params(model, dtype=torch.float32, device="cpu")
    assert config.rope_scaling == 2.0
    np.testing.assert_allclose(ours(model), hf_logits(model), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_state_dict_path_needs_config():
    model = tiny_hf()
    with pytest.raises(ValueError, match="hf_config"):
        load_llama_params(model.state_dict(), device="cpu")
    params, config = load_llama_params(model.state_dict(), model.config,
                                       dtype=torch.float32, device="cpu")
    got = torch_t.forward(params, torch.from_numpy(TOKENS), config)
    np.testing.assert_allclose(to_np(got), hf_logits(model), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    sd = {k: v for k, v in model.state_dict().items()
          if k != "model.layers.1.mlp.up_proj.weight"}
    with pytest.raises(KeyError, match="up_proj"):
        load_llama_params(sd, model.config, device="cpu")


def test_loader_defaults_to_cuda_and_imports_no_transformers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_llama_params(tiny_hf())
    src = Path(__file__).resolve().parent.parent / (
        "bee_code_interpreter_tpu_torch/models/hf_loader.py")
    tree = ast.parse(src.read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m.split(".")[0] for m in names} & {"transformers", "jax"}
