"""Carry state across from million_tpu (JAX) to the port, as numpy arrays.

The caller turns JAX arrays into numpy (np.asarray); nothing here imports
JAX. The reference package's at-rest formats are translated:
  codes: (..., M, N/4) int32 words, byte t of word w = token 4w+t,
         subspace-major  ->  (..., N, M) uint8 token-major;
  outlier channels: byte planes (..., 4, O, N/4), [..., b, :, w] = token
         4w+b  ->  (..., N, O) bf16;
  page pools: the same two translations page by page (a page is a small
         arena), the bookkeeping arrays carried over as they are.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from million_tpu_torch import resolve_device


def _tensor(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    # bf16 numpy arrays (ml_dtypes) have no torch counterpart: go through f32
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device=dev, dtype=dtype)


def unpack_codes(words: np.ndarray) -> np.ndarray:
    """Packed words (..., M, NW) int32 -> transposed codes (..., M, 4*NW) uint8."""
    u = np.asarray(words).astype(np.uint32)
    b = np.stack([(u >> (8 * t)) & 0xFF for t in range(4)], axis=-1)
    return b.reshape(*u.shape[:-1], u.shape[-1] * 4).astype(np.uint8)


def from_byte_plane(x: np.ndarray) -> np.ndarray:
    """Byte-plane slab (..., 4, O, NW) -> linear (..., N, O)."""
    y = np.moveaxis(np.asarray(x), -3, -1)  # (..., O, NW, 4)
    lin = y.reshape(*y.shape[:-2], -1)  # (..., O, N), n = 4w + b
    return np.swapaxes(lin, -1, -2)


def arena_from_words(words: np.ndarray) -> np.ndarray:
    """JAX code arena (..., M, NW) int32 -> port arena (..., N, M) uint8."""
    return np.ascontiguousarray(np.swapaxes(unpack_codes(words), -1, -2))


def params_from_numpy(tree: Dict[str, Any], dtype: torch.dtype = torch.bfloat16,
                      device="cuda") -> Dict[str, Any]:
    """A million_tpu init_params tree (numpy leaves) -> the port's params.
    The stored layouts are the same, so this is a copy."""
    dev = resolve_device(device)
    out = {k: _tensor(v, dtype, dev) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: _tensor(v, dtype, dev) for k, v in tree["layers"].items()}
    return out


def cents_from_numpy(cents: Dict[str, Any], device="cuda") -> Dict[str, torch.Tensor]:
    """{"key", "value"[, "Rk", "Rv"][, "k_outlier_idx", "v_outlier_idx"]} ->
    f32 codebooks (L, M, C, d_m), f32 OPQ rotations (L, d, d) and int32
    channel indices (L, O), contiguous on device. The rotations come as a
    pair or not at all."""
    dev = resolve_device(device)
    if ("Rk" in cents) != ("Rv" in cents):
        raise ValueError("OPQ needs both rotations, Rk and Rv")
    out = {"key": _tensor(cents["key"], torch.float32, dev),
           "value": _tensor(cents["value"], torch.float32, dev)}
    for k in ("Rk", "Rv"):
        if k in cents:
            out[k] = _tensor(cents[k], torch.float32, dev)
    for k in ("k_outlier_idx", "v_outlier_idx"):
        if k in cents:
            out[k] = _tensor(cents[k], torch.int32, dev)
    return out


def pq_cache_from_numpy(cache: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A million_tpu stacked PQ cache (numpy leaves) -> the port's cache.
    Its per-layer counters must agree across layers (they always do on the
    flat path)."""
    dev = resolve_device(device)
    if np.asarray(cache["key_codes"]).dtype != np.int32:
        raise NotImplementedError("wide int16 code arenas are a later slice of the port")
    out: Dict[str, Any] = {
        "key_codes": _tensor(arena_from_words(cache["key_codes"]), torch.uint8, dev),
        "value_codes": _tensor(arena_from_words(cache["value_codes"]), torch.uint8, dev),
    }
    res_dtype = torch.float32 if np.asarray(cache["key_residual"]).dtype == np.float32 else torch.bfloat16
    for k in ("key_residual", "value_residual"):
        out[k] = _tensor(cache[k], res_dtype, dev)
    for k in ("key_outliers", "value_outliers"):
        if k in cache:
            out[k] = _tensor(from_byte_plane(cache[k]), torch.bfloat16, dev)
    for k in ("n_codes", "r"):
        c = np.asarray(cache[k]).reshape(-1)
        if (c != c[0]).any():
            raise ValueError(f"{k} differs across layers: {c}")
        out[k] = int(c[0])
    return out


def paged_state_from_numpy(state: Dict[str, Any], pcfg, device="cuda") -> Dict[str, torch.Tensor]:
    """A million_tpu paged state (numpy leaves: word-packed pools, byte-plane
    outlier pools, `used`, `page_table`, the seq_* counters, the residual
    windows) -> the port's paged state for the PagedPQCacheConfig `pcfg`,
    so that both packages can be stepped from the same cache."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for k in ("key_pool", "value_pool"):
        if np.asarray(state[k]).dtype != np.int32:
            raise NotImplementedError("wide int16 code pools are a later slice of the port")
        out[k] = _tensor(arena_from_words(state[k]), torch.uint8, dev)
    for k in ("key_outlier_pool", "value_outlier_pool"):
        if k in state:
            out[k] = _tensor(from_byte_plane(state[k]), torch.bfloat16, dev)
    for k in ("key_residual", "value_residual"):
        out[k] = _tensor(state[k], pcfg.dtype, dev)
    for k in ("used", "page_table", "seq_n_codes", "seq_n_pages", "seq_r", "seq_active"):
        out[k] = _tensor(state[k], torch.int32, dev)
    want = (pcfg.num_layers, pcfg.n_pages + 1, pcfg.nh_k, pcfg.page_size, pcfg.M)
    if tuple(out["key_pool"].shape) != want or out["page_table"].shape != (pcfg.max_seqs, pcfg.pages_per_seq):
        raise ValueError(f"state does not match the config: key_pool {tuple(out['key_pool'].shape)}, "
                         f"want {want}")
    return out
