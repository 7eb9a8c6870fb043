"""The port's HF loader against million_tpu's on tiny checkpoints this test
writes itself (safetensors.numpy, f32, no download): llama with an untied
head, qwen2 with q/k/v biases, one file or sharded with an index. Params
equal million_tpu.models.hf_loader's, dense prefill logits within 1e-4 of
million_tpu's, and config_from_hf equal field by field (llama3 and yarn rope
scaling included)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

safetensors_numpy = pytest.importorskip("safetensors.numpy")

from million_tpu.cache.dense_cache import DenseCacheConfig as JDenseCfg, init_dense_state as j_init_dense
from million_tpu.models import hf_loader as jhf
from million_tpu.models import llama as jl
from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.models import hf_loader as thf
from million_tpu_torch.models import llama as tl

HF = dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0)


def write_checkpoint(d, model_type="llama", tie=False, shards=1, seed=0, **extra):
    rng = np.random.default_rng(seed)
    D, I, V, L = HF["hidden_size"], HF["intermediate_size"], HF["vocab_size"], HF["num_hidden_layers"]
    dh = D // HF["num_attention_heads"]
    nk = HF["num_key_value_heads"] * dh
    w = lambda *sh: (rng.standard_normal(sh) * 0.1).astype(np.float32)
    t = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D)}
    for i in range(L):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": 1 + w(D), p + "post_attention_layernorm.weight": 1 + w(D),
                  p + "self_attn.q_proj.weight": w(D, D), p + "self_attn.k_proj.weight": w(nk, D),
                  p + "self_attn.v_proj.weight": w(nk, D), p + "self_attn.o_proj.weight": w(D, D),
                  p + "mlp.gate_proj.weight": w(I, D), p + "mlp.up_proj.weight": w(I, D),
                  p + "mlp.down_proj.weight": w(D, I)})
        if model_type == "qwen2":
            t.update({p + "self_attn.q_proj.bias": w(D), p + "self_attn.k_proj.bias": w(nk),
                      p + "self_attn.v_proj.bias": w(nk)})
    if not tie:
        t["lm_head.weight"] = w(V, D)
    d.mkdir(parents=True, exist_ok=True)
    names = sorted(t)
    weight_map = {}
    for s in range(shards):
        part = names[s::shards]
        fname = "model.safetensors" if shards == 1 else f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        safetensors_numpy.save_file({k: t[k] for k in part}, str(d / fname))
        weight_map.update({k: fname for k in part})
    if shards > 1:
        (d / "model.safetensors.index.json").write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))
    (d / "config.json").write_text(json.dumps({**HF, "model_type": model_type, "tie_word_embeddings": tie,
                                               **extra}))
    return d


def fields(cfg):
    out = dataclasses.asdict(cfg)
    out.pop("dtype")
    return out


CASES = {
    "llama": dict(),
    "llama_tied_sharded": dict(tie=True, shards=3),
    "qwen2": dict(model_type="qwen2"),
    "llama3": dict(rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                                 "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
                   rope_theta=500000.0),
    "yarn": dict(rope_scaling={"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_config_from_hf_matches_million_tpu(tmp_path, case):
    d = write_checkpoint(tmp_path / case, **CASES[case])
    t, j = thf.config_from_hf(str(d)), jhf.config_from_hf(str(d))
    assert fields(t) == fields(j)
    assert t.dtype == torch.bfloat16
    if case == "qwen2":
        assert t.attn_bias
    if case in ("llama3", "yarn"):
        assert t.rope_scaling == case
    if case == "yarn":
        assert t.rope_original_max_position == 64 and t.rope_scaling_factor == 4.0


@pytest.mark.parametrize("case", list(CASES))
def test_params_and_logits_match_million_tpu(tmp_path, case):
    d = write_checkpoint(tmp_path / case, seed=len(case), **CASES[case])
    jcfg = dataclasses.replace(jhf.config_from_hf(str(d)), dtype=jnp.float32)
    tcfg = dataclasses.replace(thf.config_from_hf(str(d)), dtype=torch.float32)
    jp = jhf.load_hf_weights(str(d), jcfg, dtype=jnp.float32)
    tp = thf.load_hf_weights(str(d), tcfg, dtype=torch.float32, device="cpu")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for k in tp:
        if k != "layers":
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)
    for k in tp["layers"]:
        assert tp["layers"][k].dtype == torch.float32
        np.testing.assert_array_equal(tp["layers"][k].numpy(), np.asarray(jp["layers"][k]), err_msg=k)
    ids = np.array([[5, 80, 33, 2, 61, 17, 9, 44, 71, 20]])
    lj, _ = jl.prefill(jp, jcfg, jnp.asarray(ids, jnp.int32),
                       j_init_dense(JDenseCfg(bs=1, nh_k=jcfg.num_kv_heads, d=jcfg.head_dim, N_max=32,
                                              dtype=jnp.float32), jcfg.num_layers), None, mode="dense")
    lt = tl.prefill(tp, tcfg, torch.from_numpy(ids), init_dense_state(
        DenseCacheConfig(bs=1, nh_k=tcfg.num_kv_heads, d=tcfg.head_dim, N_max=32, dtype=torch.float32),
        tcfg.num_layers, device="cpu"), None, mode="dense")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


def test_loader_errors(tmp_path):
    d = tmp_path / "empty"
    d.mkdir()
    with pytest.raises(FileNotFoundError, match="safetensors"):
        thf.load_hf_weights(str(d), tl.PRESETS["test-tiny"], device="cpu")
    d = write_checkpoint(tmp_path / "ck")
    cfg = dataclasses.replace(thf.config_from_hf(str(d)), attn_bias=True)  # biases the checkpoint lacks
    with pytest.raises(KeyError, match="bias"):
        thf.load_hf_weights(str(d), cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            thf.load_hf_weights(str(d), thf.config_from_hf(str(d)))
