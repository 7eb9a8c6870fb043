"""Carry state across from million_tpu (JAX) to the port, as numpy arrays.

The caller turns JAX arrays into numpy (np.asarray); nothing here imports
JAX. The reference package's at-rest formats are translated:
  codes: (..., M, N/4) int32 words, byte t of word w = token 4w+t,
         subspace-major  ->  (..., N, M) uint8 token-major; a wide arena
         (C > 256), (..., M, N) int16 subspace-major  ->  (..., N, M) int16
         token-major (arena_to_numpy goes back, for the tests);
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


def arena_from_numpy(arena: np.ndarray) -> np.ndarray:
    """A JAX code arena of either storage -> the port's token-major arena:
    packed int32 words (..., M, N/4) -> (..., N, M) uint8; a wide int16
    arena (..., M, N) -> (..., N, M) int16, the same bits."""
    a = np.asarray(arena)
    if a.dtype == np.int16:
        return np.ascontiguousarray(np.swapaxes(a, -1, -2))
    if a.dtype != np.int32:
        raise ValueError(f"a code arena is int32 words or int16 codes, got {a.dtype}")
    return arena_from_words(a)


def arena_to_numpy(arena: torch.Tensor) -> np.ndarray:
    """Inverse of arena_from_numpy: the port's (..., N, M) arena -> the JAX
    package's, int16 (..., M, N) or packed int32 words (..., M, N/4)."""
    a = np.swapaxes(arena.detach().cpu().numpy(), -1, -2)  # (..., M, N)
    if a.dtype == np.int16:
        return np.ascontiguousarray(a)
    b = a.astype(np.uint32).reshape(*a.shape[:-1], a.shape[-1] // 4, 4)
    return (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24).view(np.int32)


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
    out: Dict[str, Any] = {}
    for k in ("key_codes", "value_codes"):
        a = arena_from_numpy(cache[k])
        out[k] = torch.from_numpy(a).to(dev) if a.dtype == np.int16 else _tensor(a, torch.uint8, dev)
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
            raise NotImplementedError(
                "page pools hold 8-bit codes in both packages (int32 words of four); wide int16 "
                "codes (C > 256) take the flat cache")
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
