"""The port's side of the architecture "llama": million_tpu_torch's
ModelConfig of a configuration file, and the paged PQ pool of a mix, with a
slot in the pool for each layer of reference/llama.py's pq_layers."""

from __future__ import annotations

from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
from million_tpu_torch.models.llama import ModelConfig

from perfbench.inputs import DTYPES
from perfbench.reference.llama import pq_layers


def model_config(m: dict) -> ModelConfig:
    if m.get("rope_scaling"):
        raise ValueError("rope scaling is not read by this harness yet")
    return ModelConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        intermediate_size=m["intermediate_size"], num_layers=m["num_hidden_layers"],
        num_heads=m["num_attention_heads"], num_kv_heads=m["num_key_value_heads"],
        head_dim=m["head_dim"], rope_theta=float(m["rope_theta"]), rms_eps=float(m["rms_norm_eps"]),
        tie_word_embeddings=bool(m["tie_word_embeddings"]), attn_bias=bool(m.get("attention_bias")),
        dtype=DTYPES[m["torch_dtype"]])


def cache_config(m: dict, mix: dict) -> PagedPQCacheConfig:
    d, pq, paging = m["head_dim"], m["pq"], m["paging"]
    slots, pps = mix["slots"], mix["pages_per_slot"]
    return PagedPQCacheConfig(
        num_layers=len(pq_layers(m)), nh_k=m["num_key_value_heads"], d=d, M=d // pq["d_m"],
        C=pq["C"], Lt=paging["Lt"], page_size=paging["page_size"],
        n_pages=slots * pps, max_seqs=slots, pages_per_seq=pps,
        dtype=DTYPES[m["torch_dtype"]], OK=pq["outliers"], OV=pq["outliers"])
