"""Chunked PQ prefill: long prompts in bounded-memory chunks.

Counterpart of million_tpu/models/chunked_prefill.py. A one-shot prefill
holds the activations of the whole prompt at once; chunking bounds that to
`chunk` tokens. Each chunk runs the normal transformer stack, and its
attention is the LSE-merge of two partials:

  * causal attention WITHIN the chunk (exact). On the card that is the
    hand-written kernel of ops/causal_attention_kernel.py, which keeps the
    scores in registers and skips the tiles above the diagonal; its plain
    version walks the keys a block at a time;
  * full attention against the QUANTIZED history: the code arena that the
    earlier chunks already wrote. On the card that is the hand-written
    kernel of ops/pq_chunk_attention_kernel.py, which decodes the history a
    tile at a time in shared memory; its plain version decodes one
    `hist_block` of tokens at a time. Either way the dense history K/V is
    never whole in memory.

Attending to quantized history is the approximation the decode path makes for
every generated token. Contract: mode "pq", a fresh cache at the first chunk,
chunk % 4 == 0; the ragged tail of the LAST chunk goes to the residual window
as in the flat prefill. The cache is updated IN PLACE and its counters, host
ints shared by all layers, advance once per chunk.

Unlike the reference package's plain route, the plain history route here
applies the outlier terms, because it is the kernel's plain version. The
reference's power-of-two block bucketing and kernel block choice limit XLA
recompiles and Mosaic block shapes; the kernel here takes the history length
as a host integer.

Wide codes (an int16 arena, C > 256): the history partial takes its plain
route (`_history_partial`), as the reference package does for wide
codebooks (million_tpu/models/chunked_prefill.py:82-84); the in-chunk causal
kernel and the encode kernel still run on the card. The route comes from the
arena's dtype (llama.attention_route), before any launch.

OPQ (cents "Rk" / "Rv"): the stored k / v rotate; the in-chunk partial stays
in the original space, the history partial runs in rotated space (q rotated
by Rk) and its output unrotates by Rv^T once per layer and chunk, before the
two partials merge. Not in this slice (raises NotImplementedError): mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from million_tpu_torch.cache.pq_cache import WORD, stacked_prefix_write
from million_tpu_torch.models.llama import (
    SUBSPACE_LAYOUT,
    ModelConfig,
    Params,
    _layer,
    _layer_rots,
    _logits,
    _mlp,
    _opq_rotate,
    _qkv,
    _rms_norm,
    _rope,
    _unsupported,
    attention_route,
)
from million_tpu_torch.ops.causal_attention_kernel import causal_partial, causal_partial_plain
from million_tpu_torch.ops.pq_attention_ref import merge_two_partials
from million_tpu_torch.ops.pq_chunk_attention_kernel import (
    group_rows,
    history_precision,
    pq_chunk_attention_plain,
    pq_chunk_history_attention,
    ungroup_rows,
)
from million_tpu_torch.pq.ops import runtime_encode, zero_channels


# the plain in-chunk partial under the name the tests know
_causal_partial = causal_partial_plain


def _history_partial(q, key_codes, value_codes, kcent, vcent, n_prev: int, scale: float,
                     hist_block: int = 4096, **outliers):
    """The plain history route: full attention of the chunk's queries against
    the first n_prev quantized tokens, decoded one hist_block at a time (the
    kernel's plain version behind the GQA regrouping, at the precision the
    kernel route takes for this model).

    q (bs, nh, nc, d) raw; key_codes/value_codes (bs, nh_k, N_max, M), uint8
    or int16;
    outliers = koidx, k_outliers, voidx, v_outliers as in
    pq_chunk_history_attention. Returns (out (bs, nh, nc, d) f32 normalised,
    lse (bs, nh, nc) f32)."""
    out, lse = pq_chunk_attention_plain(
        group_rows(q, key_codes.shape[1], scale), key_codes, value_codes, kcent, vcent,
        n_prev, hist_block=hist_block, precision=history_precision(
            q, value_codes, outliers.get("k_outliers"), outliers.get("v_outliers"), key_codes),
        **outliers)
    return ungroup_rows(out, lse, q.shape[1])


@torch.no_grad()
def _prefill_one_chunk(
    params: Params,
    cfg: ModelConfig,
    ids: torch.Tensor,  # (bs, nc)
    cache: Dict[str, Any],
    cents: Dict[str, torch.Tensor],
    pos_offset: int,  # global position of ids[:, 0]
    last_chunk: bool,
    hist_block: int = 4096,
    use_kernel: bool = True,  # both partials through their wrappers; False: their plain versions
) -> Optional[torch.Tensor]:
    """One chunk through every layer: encode and write the chunk's codes at
    n_codes, attend causally within the chunk and over the history
    [0, n_codes) that earlier chunks wrote, then advance the counters.
    Returns the last token's logits (bs, V) f32 for the last chunk, else
    None (only the final chunk's logits are consumed)."""
    bs, nc = ids.shape
    scale = 1.0 / (cfg.head_dim**0.5)
    n4 = (nc // WORD) * WORD if last_chunk else nc
    tail = nc - n4
    n_prev = cache["n_codes"]  # history BEFORE this chunk's write
    kernel_history = use_kernel and attention_route(cache["key_codes"].dtype) == "pq_kernel"
    x = params["embed"][ids]
    rope = _rope(cfg, pos_offset + torch.arange(nc, device=x.device), x.device)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, rope)
        Rk, Rv = _layer_rots(cents, i)
        k_st = k if Rk is None else _opq_rotate(k, Rk)
        v_st = v if Rv is None else _opq_rotate(v, Rv)
        k_enc, v_enc = k_st[:, :, :n4], v_st[:, :, :n4]
        k_out = v_out = None
        hokw = {}
        if "k_outlier_idx" in cents:
            koidx = cents["k_outlier_idx"][i]
            k_out = k_enc.index_select(-1, koidx.long())
            k_enc = zero_channels(k_enc, koidx)
            hokw.update(koidx=koidx, k_outliers=cache["key_outliers"][i])
        if "v_outlier_idx" in cents:
            voidx = cents["v_outlier_idx"][i]
            v_out = v_enc.index_select(-1, voidx.long())
            v_enc = zero_channels(v_enc, voidx)
            hokw.update(voidx=voidx, v_outliers=cache["value_outliers"][i])
        kc = runtime_encode(k_enc, cents["key"][i], SUBSPACE_LAYOUT)
        vc = runtime_encode(v_enc, cents["value"][i], SUBSPACE_LAYOUT)
        stacked_prefix_write(
            cache, i, kc, vc,
            k_st[:, :, n4:] if tail else None, v_st[:, :, n4:] if tail else None,
            k_out=k_out, v_out=v_out,
        )
        attn, lse_c = (causal_partial if use_kernel else causal_partial_plain)(q, k, v, scale)
        if n_prev:
            history = pq_chunk_history_attention if kernel_history else _history_partial
            out_h, lse_h = history(
                q if Rk is None else _opq_rotate(q, Rk), cache["key_codes"][i], cache["value_codes"][i], cents["key"][i],
                cents["value"][i], n_prev, scale, hist_block=hist_block, **hokw)
            if Rv is not None:  # back to the in-chunk partial's V basis before the merge
                out_h = _opq_rotate(out_h, Rv.t())
            attn, _ = merge_two_partials(attn, lse_c, out_h, lse_h)
        attn = attn.to(x.dtype).transpose(1, 2).reshape(bs, nc, -1)
        x = x + F.linear(attn, lp["wo"]).to(x.dtype)
        h = _rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp).to(x.dtype)
    cache["n_codes"] += n4
    cache["r"] += tail
    if not last_chunk:
        return None
    return _logits(params, cfg, x[:, -1:])[:, 0]


@torch.no_grad()
def chunked_prefill(
    params: Params,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # (bs, n)
    cache: Dict[str, Any],  # fresh stacked PQ cache, updated in place
    cents: Dict[str, torch.Tensor],
    *,
    chunk: int = 4096,
    hist_block: int = 4096,
    mesh=None,
    use_kernel: Optional[bool] = None,  # None: the kernel for CUDA tensors
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill `input_ids` in `chunk`-token pieces (a host loop). Returns
    (last-token logits (bs, V) f32, the decode-ready cache). use_kernel=False
    takes the plain versions of both partials on any device; the default
    takes their wrappers (causal_partial, pq_chunk_history_attention), which
    launch the kernels for CUDA tensors and run the plain versions for CPU
    tensors; an int16 (wide-code) arena takes the plain history route. The plain history version decodes hist_block history tokens at
    a time (its memory bound); the kernel walks the history in its own tiles
    and does not read it."""
    _unsupported(mesh=mesh)
    if chunk <= 0 or chunk % WORD:
        raise ValueError("chunk must be a positive multiple of 4")
    if hist_block <= 0:
        raise ValueError("hist_block must be positive")
    bs, n = input_ids.shape
    if n < 1:
        raise ValueError("empty prompt")
    n_max = cache["key_codes"].shape[3]
    if n - n % WORD > n_max:
        raise ValueError(f"aligned prompt prefix {n - n % WORD} exceeds arena N_max {n_max}")
    if cache["n_codes"] != 0 or cache["r"] != 0:
        raise ValueError(
            "chunked_prefill requires a FRESH cache (n_codes == 0): positions and "
            "history bookkeeping start at 0")
    if use_kernel is None:
        use_kernel = True
    logits = None
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        logits = _prefill_one_chunk(
            params, cfg, input_ids[:, s:e], cache, cents, s, last_chunk=(e == n),
            hist_block=hist_block, use_kernel=use_kernel)
    return logits, cache
