"""Sequence-parallel PQ prefill: the prompt's activations split over the
mesh's sequence axes.

Counterpart of million_tpu/parallel/sp_prefill.py. Each sequence shard
embeds, projects and encodes only its own contiguous block of the prompt
(through the fused encode kernel, B7, on the card); the attention runs as a
ring (ring_attention.ring_causal_local). One all-gather of codes a layer (key
and value codes in one message, and one more for the exact outlier channels
where the cache keeps them) re-lays them out from prompt layout (n / P tokens
a shard) to arena layout (N_max / P a shard): every shard then keeps the part
of the prompt its own arena shard owns.

Scope, as the reference's: mode "pq", a FRESH cache (n_codes == 0: this is
the admission prefill, not a continuation), prompt length divisible by 4.
A prompt not divisible by 4 x (sequence shards) is padded at its end; the
pad tokens come after every real token, so they change nothing, their codes
are not written, and the logits are taken at the last REAL token (its shard
and offset). OPQ rotations apply per shard (stored codes in rotated space,
the ring in the original space). Unlike the reference's, which keeps
replicated weights and writes no exact outlier channels, the weights may be
tp-split (the two row-parallel all-reduces of models/llama.py) and the
outlier channels are zeroed before the encode and kept exactly, as in the
flat prefill (ROADMAP section C).

Returns the last-token logits (bs_l, V) f32, the same on every shard of the
sequence axes, and leaves the cache decode-ready: n_codes = n, r = 0.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from million_tpu_torch.cache.pq_cache import WORD
from million_tpu_torch.models.llama import (
    SUBSPACE_LAYOUT,
    ModelConfig,
    Params,
    _attn_out,
    _layer,
    _layer_rots,
    _logits,
    _mlp,
    _opq_rotate,
    _qkv,
    _rms_norm,
    _rope,
)
from million_tpu_torch.parallel.mesh import Mesh
from million_tpu_torch.parallel.ring_attention import ring_causal_local
from million_tpu_torch.pq.ops import runtime_encode, zero_channels


@torch.no_grad()
def prefill_sp(
    params: Params,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # (bs_l, n): this rank's batch slice, the whole prompt
    cache: Dict[str, Any],  # this rank's fresh flat PQ cache shard, updated in place
    cents: Dict[str, torch.Tensor],
    mesh: Mesh,
    axis: str = "seq",
) -> torch.Tensor:
    bs, n = input_ids.shape
    Pn, i = mesh.size(axis), mesh.index(axis)
    if n % WORD:
        raise ValueError(f"prompt length {n} must divide {WORD} (one code word); ragged tails go "
                         "through the flat prefill or decode steps")
    if cache["n_codes"] != 0 or cache["r"] != 0:
        raise ValueError("prefill_sp requires a FRESH cache (n_codes == 0); it is the admission "
                         "prefill, not a chunked continuation")
    n_local = cache["key_codes"].shape[3]  # this shard's arena tokens
    if n > n_local * Pn:
        raise ValueError("prompt longer than the code arena")
    span = WORD * Pn
    n_pad = -(-n // span) * span
    if n_pad > n_local * Pn:
        raise ValueError(f"padded prompt ({n_pad} tokens for {Pn} shards) exceeds the code arena; "
                         "grow N_max or use the flat prefill")
    n_loc = n_pad // Pn
    ids = torch.nn.functional.pad(input_ids, (0, n_pad - n))[:, i * n_loc:(i + 1) * n_loc]
    scale = 1.0 / (cfg.head_dim**0.5)
    # this arena shard's share [a, b) of the real prompt
    a, b = min(i * n_local, n), min((i + 1) * n_local, n)
    x = params["embed"][ids]
    rope = _rope(cfg, i * n_loc + torch.arange(n_loc, device=x.device), x.device)
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, rope)
        Rk, Rv = _layer_rots(cents, li)
        k_st = k if Rk is None else _opq_rotate(k, Rk)
        v_st = v if Rv is None else _opq_rotate(v, Rv)
        outs = []
        if "k_outlier_idx" in cents:
            koidx = cents["k_outlier_idx"][li]
            outs.append(k_st.index_select(-1, koidx.long()))
            k_st = zero_channels(k_st, koidx)
        if "v_outlier_idx" in cents:
            voidx = cents["v_outlier_idx"][li]
            outs.append(v_st.index_select(-1, voidx.long()))
            v_st = zero_channels(v_st, voidx)
        kc = runtime_encode(k_st, cents["key"][li], SUBSPACE_LAYOUT)  # (bs, nh_k, n_loc, M)
        vc = runtime_encode(v_st, cents["value"][li], SUBSPACE_LAYOUT)
        M = kc.shape[-1]
        # prompt layout -> arena layout: one gather of this layer's codes over the shards
        codes = mesh.all_gather(torch.cat([kc, vc], dim=-1), axis, dim=2)
        cache["key_codes"][li, :, :, :b - a] = codes[:, :, a:b, :M]
        cache["value_codes"][li, :, :, :b - a] = codes[:, :, a:b, M:]
        if outs:
            exact = mesh.all_gather(torch.cat(outs, dim=-1).to(torch.bfloat16), axis, dim=2)
            ok = 0
            if "key_outliers" in cache:
                ok = cache["key_outliers"].shape[-1]
                cache["key_outliers"][li, :, :, :b - a] = exact[:, :, a:b, :ok]
            if "value_outliers" in cache:
                cache["value_outliers"][li, :, :, :b - a] = exact[:, :, a:b, ok:]
        attn = ring_causal_local(q, k, v, mesh, scale, axis)
        attn = attn.transpose(1, 2).reshape(bs, n_loc, -1)
        x = x + _attn_out(attn, lp, mesh).to(x.dtype)
        h = _rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp, mesh).to(x.dtype)
    # the last REAL token's hidden state, summed over the shards from its owner
    owner, off = (n - 1) // n_loc, (n - 1) % n_loc
    last = x[:, off].to(torch.float32) * (1.0 if i == owner else 0.0)
    last = mesh.all_reduce(last, axis).to(x.dtype)
    cache["n_codes"], cache["r"] = n, 0
    return _logits(params, cfg, last[:, None])[:, 0]
