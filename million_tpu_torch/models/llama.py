"""Llama-family model in PyTorch, with the KV cache (PQ or dense) as explicit
state updated in place.

Counterpart of million_tpu/models/llama.py. Parameters are a plain dict of
tensors with million_tpu's stored layout: every per-layer weight is stacked
on a leading (L, ...) axis and the attention projections are stored (out, in),
so carrying weights across (million_tpu_torch.convert) is a copy. Layers run
as a Python loop over views of those stacks.

Decode attention modes:
  "dense"     exact attention over a dense bf16 cache (the baseline);
  "pq"        the kernel's plain PyTorch version in one pass over the code
              arena plus the exact residual window (million_tpu's "pq"
              oracle, pq_decode_attention_ref, computes the same);
  "pq_kernel" the hand-written CUDA kernel over the code arena plus the exact
              residual window, LSE-merged (million_tpu's "pq_pallas").
Both run through parallel/sharded_decode.py, which without a mesh is one
call over the whole arena.
On CPU tensors "pq_kernel" runs the kernel's plain PyTorch version. On an
int16 code arena (wide codes, C > 256) "pq_kernel" takes the "pq" route, as
the reference package demotes "pq_pallas" (million_tpu/models/llama.py:568-
571): no decode attention kernel of either package reads wide codes, and
`attention_route` decides it from the arena's dtype before any launch. Every
encode (prefill and flush) still runs the fused encode kernel on the card.

OPQ: cents may carry per-layer rotations "Rk" / "Rv" (L, d, d). The cache
then lives in rotated space: the stored k / v are rotated in f32 and cast
back, the decode q rotates by Rk, and the attention output unrotates by Rv^T
before wo. Prefill attention stays in the original space. The rotations are
plain matrix products outside the kernels, as in the reference.

Meshes (parallel/mesh.py, one process per rank): with `mesh=` every rank
holds its own slices: the parameters split by heads and MLP columns over tp
(an all-reduce after wo and after w_down joins the partial sums, the two
that GSPMD inserted for the reference), the batch over dp, and the code
arena over the sequence axes in contiguous ranges. A write of codes (prefill,
flush) lands only on the rank that owns the position; the residual window is
replicated, and the decode attention runs the kernel over each rank's shard
and LSE-merges (parallel/sharded_decode.py). Callers pass each rank's batch
slice, and the logits they get back are that slice's.

`forward` is the dense transformer body that `prefill` and the trainer's
`loss_fn` (benchmarks/tiny_lm.py) share: prefill runs it under no_grad with
its cache writes, the loss through autograd with none.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from million_tpu_torch import resolve_device
from million_tpu_torch.cache.dense_cache import dense_write
from million_tpu_torch.cache.pq_cache import WORD, stacked_prefix_write
from million_tpu_torch.ops.pq_attention_ref import causal_attention
from million_tpu_torch.ops.pq_encode_kernel import pq_encode_fused_plain, pq_encode_fused_stacked
from million_tpu_torch.parallel.mesh import overlap
from million_tpu_torch.parallel.sharded_decode import sharded_pq_codes_attention_stacked
from million_tpu_torch.pq.ops import (
    RUNTIME_ENCODE_PRECISION,
    pq_decode,
    restore_channels,
    runtime_encode,
    zero_channels,
)

SUBSPACE_LAYOUT = "strided"  # subspace m owns head dims {m, m+M, ...}

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_word_embeddings: bool = False
    rope_scaling: Optional[str] = None  # None | "llama3" | "yarn"
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0  # llama3 scaling
    rope_high_freq_factor: float = 4.0  # llama3 scaling
    rope_original_max_position: int = 8192
    rope_beta_fast: float = 32.0  # yarn scaling
    rope_beta_slow: float = 1.0
    rope_attention_factor: Optional[float] = None  # yarn; None -> mscale(factor)
    attn_bias: bool = False  # q/k/v projection biases (qwen2 family)
    dtype: Any = torch.bfloat16


PRESETS: Dict[str, ModelConfig] = {
    "llama-2-7b": ModelConfig(),
    "llama-3.1-8b": ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
        rope_scaling="llama3",
    ),
    "llama-3.2-3b": ModelConfig(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, rope_scaling="llama3", rope_scaling_factor=32.0,
        tie_word_embeddings=True,
    ),
    "qwen2-7b": ModelConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
        rope_theta=1000000.0, attn_bias=True,
    ),
    "yarn-llama-2-7b-128k": ModelConfig(
        rope_scaling="yarn", rope_scaling_factor=32.0, rope_original_max_position=4096,
    ),
    "tinyllama-1.1b": ModelConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_layers=22, num_heads=32, num_kv_heads=4, head_dim=64,
    ),
    "test-tiny": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, dtype=torch.float32,
    ),
}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random weights (the reference's synthetic-benchmark mode): normal with
    std sqrt(2 / (fan_in + fan_out)), norms at 1. `generator` must live on
    `device`; None seeds a fresh one with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    nh, nk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(*sh):
        std = (2.0 / (sh[-2] + sh[-1])) ** 0.5
        x = torch.randn(sh, generator=generator, device=dev, dtype=torch.float32)
        return x.mul_(std).to(cfg.dtype)

    params: Params = {
        "embed": w(cfg.vocab_size, D),
        "final_norm": torch.ones(D, dtype=cfg.dtype, device=dev),
        "layers": {
            "attn_norm": torch.ones((L, D), dtype=cfg.dtype, device=dev),
            "mlp_norm": torch.ones((L, D), dtype=cfg.dtype, device=dev),
            "wq": w(L, nh * dh, D),
            "wk": w(L, nk * dh, D),
            "wv": w(L, nk * dh, D),
            "wo": w(L, D, nh * dh),
            "w_gate": w(L, D, I),
            "w_up": w(L, D, I),
            "w_down": w(L, I, D),
        },
    }
    if cfg.attn_bias:
        params["layers"]["bq"] = w(L, nh * dh)
        params["layers"]["bk"] = w(L, nk * dh)
        params["layers"]["bv"] = w(L, nk * dh)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(D, cfg.vocab_size)
    return params


def _layer(params: Params, i: int) -> Params:
    return {k: v[i] for k, v in params["layers"].items()}


def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalised in f32, cast back, then scaled in the model dtype."""
    return F.rms_norm(x.to(torch.float32), (x.shape[-1],), eps=eps).to(x.dtype) * g


def _rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Inverse frequencies (dh/2,) f32 with llama-3 or YaRN rescaling."""
    dh = cfg.head_dim
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    inv = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32, device=device), exps)
    if cfg.rope_scaling == "yarn":
        def corr_dim(n_rot):
            return (dh * math.log(cfg.rope_original_max_position / (n_rot * 2 * math.pi))) / (
                2 * math.log(cfg.rope_theta))

        low = max(math.floor(corr_dim(cfg.rope_beta_fast)), 0)
        high = min(math.ceil(corr_dim(cfg.rope_beta_slow)), dh - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp(
            (torch.arange(dh // 2, dtype=torch.float32, device=device) - low) / (high - low), 0, 1)
        extrap = 1.0 - ramp
        return inv / cfg.rope_scaling_factor * (1 - extrap) + inv * extrap
    if cfg.rope_scaling == "llama3":
        low = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wavelen = 2 * math.pi / inv
        smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        smooth = torch.clamp(smooth, 0.0, 1.0)
        scaled = (1 - smooth) * inv / cfg.rope_scaling_factor + smooth * inv
        inv = torch.where(wavelen > low, inv / cfg.rope_scaling_factor, inv)
        inv = torch.where((wavelen <= low) & (wavelen > high), scaled, inv)
    return inv


def _rope_mscale(cfg: ModelConfig) -> float:
    """YaRN attention factor on cos/sin; 1.0 for every other rope mode."""
    if cfg.rope_scaling != "yarn":
        return 1.0
    if cfg.rope_attention_factor is not None:
        return cfg.rope_attention_factor
    f = cfg.rope_scaling_factor
    return 1.0 if f <= 1 else 0.1 * math.log(f) + 1.0


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(cfg: ModelConfig, device: str) -> torch.Tensor:
    """_rope_freqs computed once per (config, device): decode steps then make
    no host-to-device copy."""
    return _rope_freqs(cfg, torch.device(device))


def _rope_cos_sin(inv_freq: torch.Tensor, pos, mscale: float = 1.0):
    """cos and sin (n, dh/2) f32 of the positions: pos an (n,) tensor or an
    int (n == 1), with YaRN's attention factor folded in."""
    if isinstance(pos, int):
        ang = (inv_freq * float(pos))[None, :]
    else:
        ang = pos.to(torch.float32)[:, None] * inv_freq[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    return cos, sin


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF half-split rotation of x (..., n, dh) by cos/sin (n, dh/2)."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _apply_rope(x: torch.Tensor, pos, inv_freq: torch.Tensor,
                mscale: float = 1.0) -> torch.Tensor:
    """x (bs, nh, n, dh), pos (n,) tensor or an int -> rotated x."""
    return _rotate(x, *_rope_cos_sin(inv_freq, pos, mscale))


def _rope(cfg: ModelConfig, pos, device):
    """cos/sin for every layer of one forward (computed once, not per layer)."""
    return _rope_cos_sin(_rope_freqs_on(cfg, str(device)), pos, _rope_mscale(cfg))


def _rope_per_seq(cfg: ModelConfig, pos: torch.Tensor, device):
    """_rope for one token per sequence, each at its own position: pos (S,)
    stays a device tensor (a serving tick derives it from the cache counters
    without reading them back). cos/sin (S, 1, 1, dh/2) broadcast over the
    heads of x (S, nh, 1, dh) in _rotate and _qkv."""
    cos, sin = _rope_cos_sin(_rope_freqs_on(cfg, str(device)), pos, _rope_mscale(cfg))
    return cos[:, None, None, :], sin[:, None, None, :]


def _qkv(x: torch.Tensor, lp: Params, cfg: ModelConfig, rope):
    """x (bs, n, D) -> q (bs, nh, n, dh), k/v (bs, nk, n, dh), RoPE applied
    with rope = _rope(cfg, pos, device)."""
    bs, n, _ = x.shape
    dh = cfg.head_dim
    nh, nk = lp["wq"].shape[0] // dh, lp["wk"].shape[0] // dh  # this rank's heads on a tp mesh
    qf = F.linear(x, lp["wq"], lp.get("bq"))
    kf = F.linear(x, lp["wk"], lp.get("bk"))
    vf = F.linear(x, lp["wv"], lp.get("bv"))
    q = qf.reshape(bs, n, nh, dh).transpose(1, 2)
    k = kf.reshape(bs, n, nk, dh).transpose(1, 2)
    v = vf.reshape(bs, n, nk, dh).transpose(1, 2)
    qk = _rotate(torch.cat([q, k], dim=1), *rope)  # one rotation for q and k
    return qk[:, :nh], qk[:, nh:], v


def _tp_sum(y: torch.Tensor, mesh) -> torch.Tensor:
    """The all-reduce over tp that joins a row-parallel product's partial
    sums (in the model's dtype, as GSPMD reduces the reference's einsum
    output); y itself off a tp mesh."""
    return mesh.all_reduce(y, "tp") if mesh is not None and mesh.size("tp") > 1 else y


def _mlp(x: torch.Tensor, lp: Params, mesh=None) -> torch.Tensor:
    """SwiGLU MLP; on a tp mesh w_gate / w_up hold this rank's columns and
    w_down its rows, and the partial products sum over tp."""
    return _tp_sum((F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"], mesh)


def _attn_out(attn: torch.Tensor, lp: Params, mesh=None) -> torch.Tensor:
    """The output projection attn @ wo^T; on a tp mesh wo holds this rank's
    input rows (its heads) and the partial products sum over tp."""
    return _tp_sum(F.linear(attn, lp["wo"]), mesh)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., k) @ b (k, n) with f32 output and f32 accumulation, the inputs
    kept in their storage type on the card."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32).reshape(
            *a.shape[:-1], b.shape[-1])
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head: (..., D) -> (..., V) f32, the head kept in its
    storage type (an f32 copy of a 128K-vocab head is a GB-scale transient)."""
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].t() if cfg.tie_word_embeddings else params["lm_head"]
    return _mm_f32(x.to(head.dtype), head)


def _opq_rotate(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """An OPQ rotation on the head-dim axis, x (..., d) @ R (d, d), in f32
    and cast back to x's dtype (not RoPE's _rotate)."""
    return torch.matmul(x.to(torch.float32), R).to(x.dtype)


def _layer_rots(cents, i: int):
    """Layer i's OPQ rotations (Rk, Rv), or (None, None) without OPQ."""
    if cents is None or "Rk" not in cents:
        return None, None
    return cents["Rk"][i], cents["Rv"][i]


def attention_route(code_dtype: torch.dtype, mode: str = "pq_kernel") -> str:
    """The decode attention a PQ cache whose code arena has this dtype takes
    under `mode`: "pq_kernel" over uint8 codes, the plain "pq" route over
    int16 (wide) codes, which no attention kernel reads; other modes as
    given."""
    if mode == "pq_kernel" and code_dtype == torch.int16:
        return "pq"
    return mode


def forward(params: Params, cfg: ModelConfig, input_ids: torch.Tensor, pos_offset: int = 0,
            store=None, mesh=None) -> torch.Tensor:
    """The dense transformer body: input_ids (bs, n) -> the pre-head hidden
    states (bs, n, D), exact causal attention in every layer (SDPA). `store(i,
    k, v)` sees each layer's k / v (bs, nh_k, n, d) and returns the k / v
    that layer attends (prefill's cache writes; None attends them as they
    are). Differentiable where the caller has grad on (the trainer)."""
    bs, n = input_ids.shape
    x = params["embed"][input_ids]
    rope = _rope(cfg, pos_offset + torch.arange(n, device=x.device), x.device)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, rope)
        if store is not None:
            k, v = store(i, k, v)
        attn = causal_attention(q, k, v).transpose(1, 2).reshape(bs, n, -1)
        x = x + _attn_out(attn, lp, mesh).to(x.dtype)
        h = _rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp, mesh).to(x.dtype)
    return x


def loss_fn(params: Params, cfg: ModelConfig, ids: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood (nats) of ids (bs, n) under the
    dense forward: the trainer's loss (million_tpu/benchmarks/tiny_lm.py
    _loss_fn), differentiable."""
    logits = _logits(params, cfg, forward(params, cfg, ids))
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    return -logp.gather(-1, ids[:, 1:, None].long())[..., 0].mean()


@torch.no_grad()
def prefill(
    params: Params,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # (bs, n) integer; this rank's batch slice on a mesh
    cache: Dict[str, Any],  # PQ or dense cache, updated in place; this rank's shard on a mesh
    cents: Optional[Dict[str, torch.Tensor]] = None,  # {"key": (L,M,C,dm), ...}
    pos_offset: int = 0,
    mode: str = "pq",
    distort_recent: bool = False,
    last_logit_only: bool = False,
    return_hidden: bool = False,
    mesh=None,
    use_kernel: bool = True,  # False: the encode kernel's plain version on any device
) -> torch.Tensor:
    """Full prefill; returns logits (bs, n, V) f32, or (bs, 1, V) with
    last_logit_only, or with return_hidden the pre-head hidden states (bs,
    n, D) (perplexity projects them a chunk at a time). The cache is written
    IN PLACE (million_tpu returns a new one).

    mode "pq": the 4-aligned prefix is encoded into the code arena (outlier
    channels zeroed before the encode and stored exactly), the ragged tail
    goes to the residual window; attention is exact, or with distort_recent
    runs over decode(encode(k, v)) of every position with the outlier
    channels restored exactly (the reference's perplexity protocol). On a
    mesh each rank encodes and writes only the part of the prefix its arena
    shard owns (all of it with distort_recent, which attends every code).
    mode "dense": the bf16-KV baseline."""
    if mode not in ("pq", "dense"):
        raise ValueError(f"unknown prefill mode {mode!r}")
    bs, n = input_ids.shape
    n4 = (n // WORD) * WORD
    tail = n - n4
    s0 = cache["n_codes"] if mode == "pq" else 0

    def store(i, k, v):
        if mode == "dense":
            dense_write(cache, i, k, v)
            return k, v
        # OPQ: only the stored k / v rotate; the attention stays in the original space
        Rk, Rv = _layer_rots(cents, i)
        k_st = k if Rk is None else _opq_rotate(k, Rk)
        v_st = v if Rv is None else _opq_rotate(v, Rv)
        # this rank's share [off, off + cnt) of the prefix, at `at` in its arena
        off, at, cnt = overlap(mesh, cache["key_codes"].shape[3], s0, n4)
        lo, hi = (0, n) if distort_recent else (off, off + cnt)  # the distortion needs every code
        k_enc, v_enc = k_st[:, :, lo:hi], v_st[:, :, lo:hi]
        k_out = v_out = None
        if "k_outlier_idx" in cents:
            koidx = cents["k_outlier_idx"][i]
            k_enc = zero_channels(k_enc, koidx)
            k_out = k_st[:, :, off:off + cnt].index_select(-1, koidx.long())
        if "v_outlier_idx" in cents:
            voidx = cents["v_outlier_idx"][i]
            v_enc = zero_channels(v_enc, voidx)
            v_out = v_st[:, :, off:off + cnt].index_select(-1, voidx.long())
        if hi > lo:
            kc = _prefill_encode(k_enc, cents["key"][i], use_kernel)
            vc = _prefill_encode(v_enc, cents["value"][i], use_kernel)
        else:
            kc = vc = k_st.new_zeros((bs, k.shape[1], 0, 1), dtype=torch.uint8)
        stacked_prefix_write(
            cache, i, kc[:, :, off - lo:off - lo + cnt], vc[:, :, off - lo:off - lo + cnt],
            k_st[:, :, n4:] if tail else None, v_st[:, :, n4:] if tail else None,
            k_out=k_out, v_out=v_out, at=at,
        )
        if not distort_recent:
            return k, v
        k_hat = pq_decode(kc, cents["key"][i], SUBSPACE_LAYOUT).to(k.dtype)
        v_hat = pq_decode(vc, cents["value"][i], SUBSPACE_LAYOUT).to(v.dtype)
        if "k_outlier_idx" in cents:
            k_hat = restore_channels(k_hat, k_st, koidx)
        if "v_outlier_idx" in cents:
            v_hat = restore_channels(v_hat, v_st, voidx)
        if Rk is not None:  # the reconstruction back to the original space
            k_hat, v_hat = _opq_rotate(k_hat, Rk.t()), _opq_rotate(v_hat, Rv.t())
        return k_hat, v_hat

    x = forward(params, cfg, input_ids, pos_offset, store, mesh)
    if mode == "pq":
        cache["n_codes"] += n4
        cache["r"] += tail
    else:
        cache["length"] += n
    if return_hidden:
        return x
    if last_logit_only:
        x = x[:, -1:]
    return _logits(params, cfg, x)


def _prefill_encode(x: torch.Tensor, cents: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """The prefill's encode at RUNTIME_ENCODE_PRECISION: runtime_encode, or
    with use_kernel=False the fused kernel's plain version on any device."""
    if use_kernel:
        return runtime_encode(x, cents, SUBSPACE_LAYOUT)
    return pq_encode_fused_plain(x[None], cents[None], SUBSPACE_LAYOUT, RUNTIME_ENCODE_PRECISION)[0]


def _masked_dense_decode(q, k, v):
    """Decode attention over the filled part of a dense cache: q (bs, nh, d),
    k/v (bs, nk, n, d) -> (bs, nh, d), GQA without repeating the KV heads.
    It calls torch's scaled_dot_product_attention: the reference package's
    dense baseline is plain XLA with no TPU kernel of its own, so this is the
    library's decode attention, not a port of one. The cuDNN backend is left
    out: it builds a new graph for every cache length, which costs more host
    time per step than the attention itself. A cache stored narrower than
    the model (a bf16 cache under an f32 model) is widened to q's dtype, as
    the reference's einsum promotes it."""
    if k.dtype != q.dtype:
        k, v = k.to(q.dtype), v.to(q.dtype)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.MATH]):
        out = F.scaled_dot_product_attention(q[:, :, None], k, v, enable_gqa=True)
    return out[:, :, 0]


def _pq_attention(q, cache, cents, li: int, n_codes: int, r: int, mesh, plain: bool):
    """Decode attention at layer li of the stacked cache: the code arena
    (this rank's shard on a mesh) and the exact first r rows of the residual
    window in one call of the kernel (its plain version with plain=True),
    LSE-merged across the sequence shards (parallel/sharded_decode.py).
    q (bs, nh, d) -> (bs, nh, d)."""
    bs, nh, d = q.shape
    nh_k = cache["key_codes"].shape[2]
    qg = (q.to(torch.float32) * (1.0 / d**0.5)).reshape(bs, nh_k, nh // nh_k, d)
    okw = {}
    if "key_outliers" in cache:
        okw.update(k_outliers=cache["key_outliers"], k_oidx=cents["k_outlier_idx"])
    if "value_outliers" in cache:
        okw.update(v_outliers=cache["value_outliers"], v_oidx=cents["v_outlier_idx"])
    out, _ = sharded_pq_codes_attention_stacked(
        mesh, qg, cache["key_codes"], cache["value_codes"], cents["key"], cents["value"],
        li, n_codes, k_residual=cache["key_residual"], v_residual=cache["value_residual"],
        r=r, plain=plain, **okw,
    )
    return out.reshape(q.shape).to(q.dtype)


@torch.no_grad()
def decode_step(
    params: Params,
    cfg: ModelConfig,
    token: torch.Tensor,  # (bs,) integer
    pos: int,  # absolute position of this token
    cache: Dict[str, Any],
    cents: Optional[Dict[str, torch.Tensor]] = None,
    mode: str = "pq",
    mesh=None,
) -> torch.Tensor:
    """One decode token; returns logits (bs, V) f32 and updates the cache IN
    PLACE: the token's k/v go to residual row r (PQ) or position `length`
    (dense), then the counter advances. A full residual window must be
    flushed first (flush_windows, scheduled by the host as generate does).
    The PQ attention runs over each rank's arena shard and merges across
    the sequence shards (one shard without a mesh): the kernel for
    "pq_kernel", its plain version for "pq"."""
    if mode not in ("dense", "pq", "pq_kernel"):
        raise ValueError(f"unknown decode mode {mode!r}")
    bs = token.shape[0]
    x = params["embed"][token][:, None, :]
    rope = _rope(cfg, int(pos), x.device)
    if mode != "dense":
        mode = attention_route(cache["key_codes"].dtype, mode)
        n_codes, r = cache["n_codes"], cache["r"]
        if r >= cache["key_residual"].shape[3]:
            raise ValueError("residual window is full: flush before the decode step")
    else:
        p0 = cache["length"]
        if p0 >= cache["k"].shape[3]:
            raise ValueError("dense cache is full")
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, rope)
        if mode == "dense":
            cache["k"][i, :, :, p0] = k[:, :, 0]
            cache["v"][i, :, :, p0] = v[:, :, 0]
            attn = _masked_dense_decode(
                q[:, :, 0], cache["k"][i, :, :, :p0 + 1], cache["v"][i, :, :, :p0 + 1])
        else:
            # OPQ: the decode attention runs in rotated space and its output
            # unrotates once before wo
            Rk, Rv = _layer_rots(cents, i)
            if Rk is not None:
                q, k, v = _opq_rotate(q, Rk), _opq_rotate(k, Rk), _opq_rotate(v, Rv)
            cache["key_residual"][i, :, :, r] = k[:, :, 0]
            cache["value_residual"][i, :, :, r] = v[:, :, 0]
            attn = _pq_attention(q[:, :, 0], cache, cents, i, n_codes, r + 1, mesh, plain=mode == "pq")
            if Rv is not None:
                attn = _opq_rotate(attn, Rv.t())
        attn = attn.reshape(bs, 1, -1)
        x = x + _attn_out(attn, lp, mesh).to(x.dtype)
        h = _rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _mlp(h, lp, mesh).to(x.dtype)
    if mode == "dense":
        cache["length"] = p0 + 1
    else:
        cache["r"] = r + 1
    return _logits(params, cfg, x)[:, 0]


@torch.no_grad()
def flush_windows(cache: Dict[str, Any], cents: Dict[str, torch.Tensor], n: int = 0,
                  use_kernel: bool = True, mesh=None) -> None:
    """Flush the oldest n rows of every layer's residual window into the code
    arena, IN PLACE: one fused encode per side with a codebook bank per layer
    (the kernel on the card, its plain version on the CPU or with
    use_kernel=False), codes and exact outlier channels (cast to bf16)
    written at n_codes, then the surviving rows roll down (n < Lt) or the
    window empties (n = 0 or Lt). On a mesh only the rank whose arena
    shard owns a position encodes and writes it (a window may straddle two
    shards); every rank rolls its copy of the window."""
    Lt = cache["key_residual"].shape[3]
    if n <= 0 or n >= Lt:
        n = Lt
    if n % WORD:
        raise ValueError(f"flush size {n} must be a multiple of {WORD}")
    s = cache["n_codes"]
    if cache["r"] < n:
        raise ValueError(f"flush of {n} rows with only {cache['r']} in the window")
    n_local = cache["key_codes"].shape[3]
    off, at, cnt = overlap(mesh, n_local, s, n)
    for side in ("key", "value"):
        res = cache[side + "_residual"]
        window = res[:, :, :, off:off + cnt]
        if cnt:
            encode = pq_encode_fused_stacked if use_kernel else pq_encode_fused_plain
            codes = encode(window, cents[side], SUBSPACE_LAYOUT, precision=RUNTIME_ENCODE_PRECISION)
            cache[side + "_codes"][:, :, :, at:at + cnt] = codes
            arena = cache.get(side + "_outliers")
            if arena is not None:
                idx = cents[("k" if side == "key" else "v") + "_outlier_idx"].long()
                L, bs, nk = window.shape[:3]
                sel = torch.gather(window, -1, idx[:, None, None, None, :].expand(L, bs, nk, cnt, -1))
                arena[:, :, :, at:at + cnt] = sel.to(torch.bfloat16)
        if n < Lt:
            res.copy_(torch.roll(res, -n, dims=3))
    cache["n_codes"] = s + n
    cache["r"] = cache["r"] - n if n < Lt else 0
