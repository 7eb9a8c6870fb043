"""Load HuggingFace Llama / Qwen2 checkpoints into the port's params layout.

Counterpart of million_tpu/models/hf_loader.py. Only the weights are read,
from a local directory (`config.json` and one or more `*.safetensors` files,
sharded with an index or not); nothing is downloaded. The layout is the one
`convert.params_from_numpy` gives: per-layer weights stacked on a leading (L,)
axis, the attention projections kept in HF's (out, in) orientation, the MLP
matrices and an untied head transposed to (in, out).

`safetensors` is imported inside `load_hf_weights`, which raises a clear
error where it is missing.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

from million_tpu_torch import resolve_device
from million_tpu_torch.models.llama import ModelConfig, Params


def _open_safetensors(model_dir: Path):
    try:
        from safetensors import safe_open
    except ImportError as e:
        raise RuntimeError(
            "loading HF weights needs the `safetensors` package; without it run with random "
            "weights (model.weights=null)"
        ) from e
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {model_dir}")
    handles = [safe_open(str(f), framework="pt") for f in files]
    index: Dict[str, int] = {}
    for i, h in enumerate(handles):
        for k in h.keys():
            index[k] = i
    return handles, index


def load_hf_weights(model_dir: str, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                    device="cuda") -> Params:
    """The checkpoint's weights as the port's params, in `dtype` on `device`."""
    dev = resolve_device(device)
    handles, index = _open_safetensors(Path(model_dir))

    def get(name: str) -> torch.Tensor:
        if name not in index:
            raise KeyError(f"{name} not in the checkpoint under {model_dir}")
        return handles[index[name]].get_tensor(name)

    def put(x: torch.Tensor) -> torch.Tensor:
        return x.to(device=dev, dtype=dtype).contiguous()

    L = cfg.num_layers

    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        # HF Linear stores (out, in); the MLP matrices are kept (in, out)
        return put(torch.stack([get(fmt.format(i=i)).t() if transpose else get(fmt.format(i=i))
                                for i in range(L)]))

    params: Params = {
        "embed": put(get("model.embed_tokens.weight")),
        "final_norm": put(get("model.norm.weight")),
        "layers": {
            "attn_norm": stack("model.layers.{i}.input_layernorm.weight", transpose=False),
            "mlp_norm": stack("model.layers.{i}.post_attention_layernorm.weight", transpose=False),
            "wq": stack("model.layers.{i}.self_attn.q_proj.weight", transpose=False),
            "wk": stack("model.layers.{i}.self_attn.k_proj.weight", transpose=False),
            "wv": stack("model.layers.{i}.self_attn.v_proj.weight", transpose=False),
            "wo": stack("model.layers.{i}.self_attn.o_proj.weight", transpose=False),
            "w_gate": stack("model.layers.{i}.mlp.gate_proj.weight"),
            "w_up": stack("model.layers.{i}.mlp.up_proj.weight"),
            "w_down": stack("model.layers.{i}.mlp.down_proj.weight"),
        },
    }
    if cfg.attn_bias:
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            params["layers"][ours] = stack(f"model.layers.{{i}}.self_attn.{theirs}.bias", transpose=False)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(get("lm_head.weight").t())
    return params


def config_from_hf(model_dir: str) -> ModelConfig:
    """A ModelConfig from a HF config.json (llama 1/2/3, with llama3 or yarn
    rope scaling, and qwen2)."""
    with open(Path(model_dir) / "config.json") as f:
        c = json.load(f)
    rs = c.get("rope_scaling") or {}
    rope_type = rs.get("rope_type") or rs.get("type")
    # qwen2 always carries q/k/v biases; llama-family configs may set attention_bias
    attn_bias = c.get("model_type") == "qwen2" or bool(c.get("attention_bias"))
    return ModelConfig(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c.get("num_key_value_heads", c["num_attention_heads"]),
        head_dim=c.get("head_dim", c["hidden_size"] // c["num_attention_heads"]),
        rope_theta=c.get("rope_theta", 10000.0),
        rms_eps=c.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=c.get("tie_word_embeddings", False),
        rope_scaling=rope_type if rope_type in ("llama3", "yarn") else None,
        rope_scaling_factor=rs.get("factor", 8.0),
        rope_low_freq_factor=rs.get("low_freq_factor", 1.0),
        rope_high_freq_factor=rs.get("high_freq_factor", 4.0),
        rope_original_max_position=rs.get(
            "original_max_position_embeddings",
            c.get("max_position_embeddings", 8192) if rope_type == "yarn" else 8192,
        ),
        rope_beta_fast=rs.get("beta_fast") or 32.0,
        rope_beta_slow=rs.get("beta_slow") or 1.0,
        rope_attention_factor=rs.get("attention_factor"),
        attn_bias=attn_bias,
    )
