"""Batched decode step over the paged PQ cache: the serving-path forward.

Counterpart of million_tpu/models/paged_decode.py. This is what continuous
batching runs: S sequence slots decode one token each per step, with per-slot
lengths and positions, page-table attention (the paged kernel of
ops/pq_paged_attention_kernel.py, which also merges each slot's exact
residual window) and window-flush batching: the decode step never encodes;
the scheduler runs `flush_paged_slots` when a slot's window fills, and
`paged_admit_chunked` admits long prompts in bounded-memory chunks against
the quantized history in the slot's pages (through the chunk-history kernel
of ops/pq_chunk_attention_kernel.py on a per-layer copy of those pages),
each chunk attending to itself through the causal kernel of
ops/causal_attention_kernel.py.

The paged state is updated IN PLACE. Not carried over from the reference,
because they exist for XLA or Mosaic: `_split_state` and the donated writer
programs (`_commit_words`, `_commit_words_multi`, `_commit_flush`; pools are
written by index here), the power-of-two history buckets `hw_bucket` and the
static `has_nv` / `last_chunk` / `p_bucket` variants that bound the compile
count (a prompt is admitted at its own length; `n_bound` is a plain host
integer), the padded `n_valid` form of paged_prefill_seq, the rule that an
admission chunk divides or is divided by the page size, GROUP_PAD, int8
tables and the third output `co`. Codes are written token by token through
the page table, so a flushed window or an admission chunk may straddle two
pages. `lax.scan` over layers is a Python loop.

OPQ (tables "Rk" / "Rv", the flat path's contract): pools and residual
windows hold rotated k / v, the decode q and the admission history's q rotate
by Rk, and each attention output over the rotated cache unrotates by Rv^T;
prefill and in-chunk attention stay in the original space. Not in this slice
(raises NotImplementedError): `mesh`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from million_tpu_torch.cache.paged_pq_cache import (
    PagedPQCacheConfig,
    PagedState,
    scatter_tokens,
    token_pages,
)
from million_tpu_torch.cache.pq_cache import WORD
from million_tpu_torch.models.chunked_prefill import _history_partial
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
    _rope_per_seq,
    _unsupported,
)
from million_tpu_torch.ops.causal_attention_kernel import causal_partial, causal_partial_plain
from million_tpu_torch.ops.pq_attention_ref import causal_attention, merge_two_partials
from million_tpu_torch.ops.pq_chunk_attention_kernel import pq_chunk_history_attention
from million_tpu_torch.ops.pq_encode_kernel import pq_encode_fused_stacked
from million_tpu_torch.ops.pq_paged_attention_kernel import (
    pq_paged_attention_plain,
    pq_paged_attention_stacked,
)
from million_tpu_torch.pq.ops import RUNTIME_ENCODE_PRECISION, runtime_encode

_SIDES = (("key", "k"), ("value", "v"))


def _outlier_kw(state: PagedState, tables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    kw = {}
    if "key_outlier_pool" in state:
        kw.update(k_outliers=state["key_outlier_pool"], k_oidx=tables["k_outlier_idx"])
    if "value_outlier_pool" in state:
        kw.update(v_outliers=state["value_outlier_pool"], v_oidx=tables["v_outlier_idx"])
    return kw


@torch.no_grad()
def paged_decode_step(
    params: Params,
    cfg: ModelConfig,
    pcfg: PagedPQCacheConfig,
    tokens: torch.Tensor,  # (S,) integer: last sampled token per slot
    positions: Optional[torch.Tensor],  # (S,) absolute position of `tokens`; None: from the counters
    state: PagedState,  # updated in place
    tables: Dict[str, torch.Tensor],  # {"key": (L, M, C, d_m), "value", outlier idx}
    *,
    n_bound: Optional[int] = None,  # host bound on every slot's n_codes (None: the whole table)
    use_kernel: Optional[bool] = None,  # False: the kernel's plain version on any device
    mesh=None,
) -> torch.Tensor:
    """One decode token for every slot; returns logits (S, V) f32. Inactive
    slots (seq_active == 0) still compute (lockstep batch); their counters do
    not move, they attend over nothing, and their token lands in row 0 of
    their own residual window, which is dead until an admission rewrites the
    rows it declares live (the reference, whose update is functional, copies
    the old row back instead).

    Nothing here reads the device: positions default to seq_n_codes + seq_r
    (the incoming token's absolute position; the invariant holds through
    appends and flushes), the residual rows are written by index, and the
    kernel reads each slot's n_codes and row count itself. The step does NO encoding: the new token's k/v go to the exact
    residual window only, and the caller must run `flush_paged_slots` on any
    slot whose window is full (seq_r >= Lt) BEFORE stepping it again; a slot
    stepped past a full window overwrites its last residual row."""
    _unsupported(mesh=mesh)
    S = tokens.shape[0]
    nh, nh_k, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / (dh**0.5)
    active = state["seq_active"] > 0
    r = state["seq_r"]
    n_codes = state["seq_n_codes"]
    if positions is None:
        positions = n_codes + r
    x = params["embed"][tokens][:, None, :]  # (S, 1, D)
    rope = _rope_per_seq(cfg, positions, x.device)
    # safety clamp: an unflushed full window must not write out of bounds
    wr = torch.where(active, torch.clamp(r, max=pcfg.Lt - 1), 0).long()
    rows = torch.where(active, wr + 1, 0).to(torch.int32)  # live residual rows per slot
    slot = torch.arange(S, device=x.device)
    attention = pq_paged_attention_plain if use_kernel is False else pq_paged_attention_stacked
    okw = _outlier_kw(state, tables)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, rope)
        Rk, Rv = _layer_rots(tables, i)
        if Rk is not None:
            q, k, v = _opq_rotate(q, Rk), _opq_rotate(k, Rk), _opq_rotate(v, Rv)
        # append the new token to the residual window at wr (per slot)
        state["key_residual"][i][slot, :, wr] = k[:, :, 0]
        state["value_residual"][i][slot, :, wr] = v[:, :, 0]
        qg = (q[:, :, 0].to(torch.float32) * scale).reshape(S, nh_k, nh // nh_k, dh)
        attn, _ = attention(
            qg, state["key_pool"], state["value_pool"], tables["key"], tables["value"], i,
            state["page_table"], n_codes, n_bound=n_bound, k_residual=state["key_residual"],
            v_residual=state["value_residual"], r=rows, **okw)
        if Rv is not None:
            attn = _opq_rotate(attn, Rv.t())
        attn = attn.reshape(S, 1, nh * dh).to(x.dtype)
        x = x + F.linear(attn, lp["wo"]).to(x.dtype)
        h = _rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp).to(x.dtype)
    state["seq_r"].copy_(torch.where(active, rows, r))
    return _logits(params, cfg, x)[:, 0]


@torch.no_grad()
def flush_paged_slots(
    pcfg: PagedPQCacheConfig,
    state: PagedState,
    tables: Dict[str, torch.Tensor],
    mask: torch.Tensor,  # (S,) bool: slots whose FULL residual window flushes
    mesh=None,
) -> PagedState:
    """Encode the full residual windows of the masked slots and write the
    codes into their pages; advance seq_n_codes by Lt and reset seq_r.

    One fused encode per side over every slot and layer (a codebook bank per
    layer); the codes and the exact outlier channels of unmasked slots, and
    of table entries that are not allocated, go to the scratch page. Every
    token is routed through the page table, so a window that straddles two
    pages is written to both. The window must be FULL (seq_r == Lt) for
    masked slots: the scheduler guarantees it, and grows the slot's pages
    first."""
    _unsupported(mesh=mesh)
    dev = state["key_pool"].device
    S, Lt = pcfg.max_seqs, pcfg.Lt
    mask = torch.as_tensor(mask, dtype=torch.bool).to(dev)
    t = state["seq_n_codes"][:, None] + torch.arange(Lt, device=dev)[None, :]  # (S, Lt)
    pages, offs = token_pages(state, torch.arange(S, device=dev), t, mask[:, None].expand(S, Lt))
    for side, short in _SIDES:
        window = state[side + "_residual"]  # (L, S, nh_k, Lt, d)
        codes = pq_encode_fused_stacked(window, tables[side], SUBSPACE_LAYOUT,
                                        precision=RUNTIME_ENCODE_PRECISION)
        scatter_tokens(state[side + "_pool"], None, pages, offs, codes.permute(1, 3, 0, 2, 4))
        pool = state.get(side + "_outlier_pool")
        if pool is not None:
            idx = tables[short + "_outlier_idx"].long()  # (L, O)
            sel = torch.gather(window, -1, idx[:, None, None, None, :].expand(*window.shape[:4], -1))
            scatter_tokens(pool, None, pages, offs, sel.permute(1, 3, 0, 2, 4))
    state["seq_n_codes"] += torch.where(mask, Lt, 0).to(torch.int32)
    state["seq_r"].copy_(torch.where(mask, 0, state["seq_r"]))
    return state


def _encode_and_write(state, tables, li, k, v, pages, offs, n_write: int) -> None:
    """Encode the first n_write tokens of k / v (S, nh_k, n, d) with layer
    li's codebooks and write codes and exact outlier channels at (pages,
    offs) (S, n_write)."""
    for (side, short), x in zip(_SIDES, (k, v)):
        x = x[:, :, :n_write]
        codes = runtime_encode(x, tables[side][li], SUBSPACE_LAYOUT)  # (S, nh_k, n, M)
        scatter_tokens(state[side + "_pool"], li, pages, offs, codes.transpose(1, 2))
        pool = state.get(side + "_outlier_pool")
        if pool is not None:
            sel = x.index_select(-1, tables[short + "_outlier_idx"][li].long())
            scatter_tokens(pool, li, pages, offs, sel.transpose(1, 2))


def _mark_admitted(state: PagedState, seq_ids: torch.Tensor, n_valid: torch.Tensor) -> None:
    sid = seq_ids.long()
    n4 = (n_valid // WORD) * WORD
    state["seq_n_codes"][sid] = n4.to(torch.int32)
    state["seq_r"][sid] = (n_valid - n4).to(torch.int32)
    state["seq_active"][sid] = 1


@torch.no_grad()
def paged_prefill_seq(
    params: Params,
    cfg: ModelConfig,
    pcfg: PagedPQCacheConfig,
    seq_id: int,  # slot being admitted
    input_ids: torch.Tensor,  # (1, n) integer, real tokens only
    state: PagedState,
    tables: Dict[str, torch.Tensor],
    mesh=None,
) -> Tuple[torch.Tensor, PagedState]:
    """Admit one sequence in one shot: exact-attention prefill whose K/V are
    encoded and written into the slot's (pre-allocated) pages; the 4-aligned
    prefix goes to pages, the ragged tail to the exact residual window.
    Returns (last-token logits (1, V) f32, the state, updated in place)."""
    _unsupported(mesh=mesh)
    n = input_ids.shape[1]
    n4 = (n // WORD) * WORD
    dev = input_ids.device
    sid = torch.tensor([seq_id], device=dev)
    t = torch.arange(n4, device=dev)[None, :]
    pages, offs = token_pages(state, sid, t, torch.ones_like(t, dtype=torch.bool))
    x = params["embed"][input_ids]
    rope = _rope(cfg, torch.arange(n, device=dev), dev)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, rope)
        Rk, Rv = _layer_rots(tables, i)
        k_st = k if Rk is None else _opq_rotate(k, Rk)
        v_st = v if Rv is None else _opq_rotate(v, Rv)
        if n4:
            _encode_and_write(state, tables, i, k_st, v_st, pages, offs, n4)
        if n > n4:
            state["key_residual"][i, seq_id, :, : n - n4] = k_st[0, :, n4:]
            state["value_residual"][i, seq_id, :, : n - n4] = v_st[0, :, n4:]
        attn = causal_attention(q, k, v).transpose(1, 2).reshape(1, n, -1)
        x = x + F.linear(attn, lp["wo"]).to(x.dtype)
        h = _rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp).to(x.dtype)
    _mark_admitted(state, sid, torch.tensor([n], device=dev))
    return _logits(params, cfg, x[:, -1:])[:, 0], state


def _gather_history(pool: torch.Tensor, li: int, h_pages: torch.Tensor) -> torch.Tensor:
    """The slots' history pages of layer li as one contiguous arena:
    pool[li, h_pages] (S, nph, nh_k, page_size, X) -> (S, nh_k, nph *
    page_size, X). One copy per layer and chunk; token t of a slot lands at
    position t, and positions past the history are masked by n_prev."""
    S, nph = h_pages.shape
    g = pool[li][h_pages.long()]
    return g.transpose(1, 2).reshape(S, g.shape[2], nph * g.shape[3], g.shape[4])


@torch.no_grad()
def _admit_chunked_impl(params, cfg, pcfg, seq_ids: Sequence[int], prompts: np.ndarray,
                        n_valid: Sequence[int], state: PagedState, tables, chunk: int,
                        use_kernel: Optional[bool], hist_block: int = 2048):
    """The chunked-admission loop over S equal-bucket slots. seq_ids (S,)
    host ints; prompts (S, n_pad) host integers, zero-padded to a multiple
    of `chunk`; n_valid (S,) real lengths. Per chunk and layer: encode and
    write the chunk's codes through the page table (padding goes to the
    scratch page), exact causal attention within the chunk, and full
    attention against the QUANTIZED history [0, s0) read from the slots'
    pages, LSE-merged. Returns (logits (S, V) at each slot's last real
    token, the state)."""
    dev = state["key_pool"].device
    S, n_pad = prompts.shape
    sid = torch.tensor(list(seq_ids), device=dev)
    nv = torch.tensor(list(n_valid), device=dev)
    nv4 = (nv // WORD) * WORD
    ids_all = torch.from_numpy(np.ascontiguousarray(prompts)).to(dev)
    scale = 1.0 / (cfg.head_dim**0.5)
    scratch = state["key_pool"].shape[1] - 1
    history = pq_chunk_history_attention if use_kernel is not False else _history_partial
    causal = causal_partial if use_kernel is not False else causal_partial_plain
    x = None
    for s0 in range(0, n_pad, chunk):
        nc = min(chunk, n_pad - s0)
        last_chunk = s0 + nc == n_pad
        t = (s0 + torch.arange(nc, device=dev))[None, :].expand(S, nc)
        pages, offs = token_pages(state, sid, t, t < nv4[:, None])
        if s0:
            nph = -(-s0 // pcfg.page_size)
            h_raw = state["page_table"][sid.long(), :nph]
            h_pages = torch.where(h_raw >= 0, h_raw, scratch)
        x = params["embed"][ids_all[:, s0:s0 + nc]]
        rope = _rope(cfg, s0 + torch.arange(nc, device=dev), dev)
        for i in range(cfg.num_layers):
            lp = _layer(params, i)
            h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps)
            q, k, v = _qkv(h, lp, cfg, rope)
            attn, lse_c = causal(q, k, v, scale)
            Rk, Rv = _layer_rots(tables, i)
            k_st = k if Rk is None else _opq_rotate(k, Rk)
            v_st = v if Rv is None else _opq_rotate(v, Rv)
            if s0:
                hokw = {}
                if "key_outlier_pool" in state:
                    hokw.update(koidx=tables["k_outlier_idx"][i],
                                k_outliers=_gather_history(state["key_outlier_pool"], i, h_pages))
                if "value_outlier_pool" in state:
                    hokw.update(voidx=tables["v_outlier_idx"][i],
                                v_outliers=_gather_history(state["value_outlier_pool"], i, h_pages))
                out_h, lse_h = history(
                    q if Rk is None else _opq_rotate(q, Rk), _gather_history(state["key_pool"], i, h_pages),
                    _gather_history(state["value_pool"], i, h_pages), tables["key"][i],
                    tables["value"][i], s0, scale, hist_block=hist_block, **hokw)
                if Rv is not None:
                    out_h = _opq_rotate(out_h, Rv.t())
                attn, _ = merge_two_partials(attn, lse_c, out_h, lse_h)
            # the chunk's own codes land after its history was read
            _encode_and_write(state, tables, i, k_st, v_st, pages, offs, nc)
            if last_chunk:
                # ragged real tail (up to 3 tokens) -> exact residual window; a
                # 4-row slice is written, rows past the tail are masked by seq_r
                start = torch.clamp(nv4 - s0, 0, nc - WORD)
                ridx = (start[:, None] + torch.arange(WORD, device=dev)[None, :])[:, None, :, None]
                for name, new in (("key_residual", k_st), ("value_residual", v_st)):
                    tail = torch.gather(new, 2, ridx.expand(S, new.shape[1], WORD, new.shape[3]))
                    state[name][i, sid.long(), :, :WORD] = tail.to(state[name].dtype)
            attn = attn.to(x.dtype).transpose(1, 2).reshape(S, nc, -1)
            x = x + F.linear(attn, lp["wo"]).to(x.dtype)
            h = _rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
            x = x + _mlp(h, lp).to(x.dtype)
    last = torch.clamp(nv - 1 - (n_pad - x.shape[1]), 0, x.shape[1] - 1)
    x_last = torch.gather(x, 1, last[:, None, None].expand(S, 1, x.shape[2]))
    _mark_admitted(state, sid, nv)
    return _logits(params, cfg, x_last)[:, 0], state


def _pad_prompts(prompts: Sequence[np.ndarray], chunk: int) -> Tuple[np.ndarray, list]:
    if chunk <= 0 or chunk % WORD:
        raise ValueError("chunk must be a positive multiple of 4")
    lens = [len(p) for p in prompts]
    if min(lens) == 0:
        raise ValueError("empty prompt")
    n_pad = -(-max(lens) // chunk) * chunk
    if any(-(-n // chunk) * chunk != n_pad for n in lens):
        raise ValueError(f"batched admission needs one shared bucket: lengths {lens} pad to "
                         f"different multiples of chunk={chunk}")
    ids = np.zeros((len(prompts), n_pad), np.int64)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = np.asarray(p)
    return ids, lens


def paged_admit_chunked(
    params: Params,
    cfg: ModelConfig,
    pcfg: PagedPQCacheConfig,
    seq_id: int,
    prompt,  # 1-D integer array (host), real tokens only
    state: PagedState,
    tables: Dict[str, torch.Tensor],
    *,
    chunk: int = 2048,
    hist_block: int = 2048,  # history block of the plain history route
    use_kernel: Optional[bool] = None,  # False: the plain versions of both partials on any device
    mesh=None,
) -> Tuple[torch.Tensor, PagedState]:
    """Host-scheduled chunked admission of one long prompt into a slot's
    pages, which must already be allocated for the full prompt. The prompt is
    padded to a multiple of `chunk`. Returns (last-real-token logits (1, V)
    f32, the state, updated in place)."""
    _unsupported(mesh=mesh)
    ids, lens = _pad_prompts([np.asarray(prompt)], chunk)
    return _admit_chunked_impl(params, cfg, pcfg, [int(seq_id)], ids, lens, state, tables, chunk,
                               use_kernel, hist_block)


def paged_admit_chunked_batch(
    params: Params,
    cfg: ModelConfig,
    pcfg: PagedPQCacheConfig,
    seq_ids: Sequence[int],  # S slot ids (host ints)
    prompts: Sequence[np.ndarray],  # S 1-D integer arrays padding to the SAME bucket
    state: PagedState,
    tables: Dict[str, torch.Tensor],
    *,
    chunk: int = 2048,
    hist_block: int = 2048,
    use_kernel: Optional[bool] = None,
    mesh=None,
) -> Tuple[torch.Tensor, PagedState]:
    """Batched chunked admission: S equal-bucket prompts admit TOGETHER, so
    the per-chunk transformer costs amortize over the group. Real lengths may
    differ within the bucket; pages must be pre-allocated per slot. Returns
    (last-real-token logits (S, V) f32, the state)."""
    _unsupported(mesh=mesh)
    ids, lens = _pad_prompts(prompts, chunk)
    return _admit_chunked_impl(params, cfg, pcfg, list(seq_ids), ids, lens, state, tables, chunk,
                               use_kernel, hist_block)
