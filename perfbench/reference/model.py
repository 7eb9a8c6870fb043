"""A llama-class decoder (GQA, RoPE, RMSNorm, SwiGLU, optional q/k/v biases)
served from a product-quantized KV cache, in plain PyTorch and float32.

What the served path computes, written out: a query at position t attends
keys and values reconstructed from their PQ codes (nearest centroid in each
subspace, subspace m owning head dims m, m + M, ...; the exact outlier
channels kept as they are) at positions before b(t), and exact ones from
b(t) to t. For a prompt admitted in chunks of c tokens b(t) = c * floor(t /
c) (one-shot: 0); for a decoded token b(t) = n4 + Lt * floor((t - n4) / Lt),
n4 the prompt length rounded down to a multiple of 4 and Lt the residual
window, since a full window is encoded before the next token. The codes are
worked out here from the reference's own keys and values.

Products with the weights, which are bf16 values, are exact f32 products:
on the card the f32 activation is split into three bf16 parts, exactly, and
each part is multiplied by the bf16 weight with f32 accumulation (TF32 off).
`precision="fp8"` is the control: every weight product takes e4m3 inputs
(per-row activation and per-column weight scales), as an fp8 serving path
would.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ROW_BLOCK = 8192  # rows of the MLP and of the encode at a time
FP8_MAX = 448.0


def _split3(x: torch.Tensor):
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """x (R, K) f32 @ w (K, N) -> (R, N) f32."""
    if precision == "fp8":
        sx = x.abs().amax(dim=1, keepdim=True).clamp(min=1e-30) / FP8_MAX
        wf = w.float()
        sw = wf.abs().amax(dim=0, keepdim=True).clamp(min=1e-30) / FP8_MAX
        xq = (x / sx).to(torch.float8_e4m3fn)
        wq = (wf / sw).to(torch.float8_e4m3fn)
        if x.is_cuda:  # e4m3 values are exact in bf16; the products accumulate in f32
            y = torch.mm(xq.to(torch.bfloat16), wq.to(torch.bfloat16), out_dtype=torch.float32)
        else:
            y = xq.float() @ wq.float()
        return y * sx * sw
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    if x.is_cuda and w.dtype == torch.bfloat16:
        return sum(torch.mm(p, w, out_dtype=torch.float32) for p in _split3(x))
    return x @ w.float()


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def rope_cos_sin(theta: float, d: int, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF's rotary tables in f32: (n, d/2) cos and sin of position x inverse
    frequency."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64, device=device).float() / d))
    ang = torch.arange(n, device=device).float()[:, None] * inv[None, :]
    return ang.cos(), ang.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x (n, heads, d)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def pq_roundtrip(x: torch.Tensor, cents: torch.Tensor, oidx: Optional[torch.Tensor]) -> torch.Tensor:
    """x (..., d) f32 -> its reconstruction from the nearest centroid of each
    subspace (cents (M, C, d_m), strided subspaces), outlier channels exact."""
    M, C, dm = cents.shape
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    out = torch.empty_like(flat)
    c = cents.float()
    c_sq = (c * c).sum(-1)  # (M, C)
    ar = torch.arange(M, device=x.device)[None, :]
    for s in range(0, flat.shape[0], ROW_BLOCK):
        xs = flat[s:s + ROW_BLOCK].reshape(-1, dm, M).transpose(1, 2)  # (r, M, dm)
        dist = torch.baddbmm(c_sq[:, None, :], xs.transpose(0, 1), c.transpose(1, 2), alpha=-2.0)
        codes = dist.argmin(-1).t()  # (r, M)
        out[s:s + ROW_BLOCK] = c[ar, codes].transpose(1, 2).reshape(-1, d)
    if oidx is not None:
        i = oidx.long()
        out[:, i] = flat[:, i]
    return out.reshape(x.shape)


def attention_blocks(n: int, N: int, chunk: Optional[int], Lt: int) -> List[Tuple[int, int, int]]:
    """(first query, end, b): query blocks [first, end) whose keys before b
    are quantized and from b on exact (causal)."""
    if chunk is None:
        blocks = [(0, n, 0)]
    else:
        blocks = [(s, min(s + chunk, n), s) for s in range(0, n, chunk)]
    n4 = n - n % 4
    t = n
    while t < N:
        b = n4 + Lt * ((t - n4) // Lt)
        end = min(b + Lt, N)
        blocks.append((t, end, b))
        t = end
    return blocks


class Reference:
    def __init__(self, weights: Dict, model: dict, tables: Dict[str, torch.Tensor],
                 precision: str = "f32"):
        self.w, self.m, self.t, self.precision = weights, model, tables, precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _lin(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
             transpose: bool = True) -> torch.Tensor:
        y = matmul(x, w.t() if transpose else w, self.precision)
        return y if b is None else y + b.float()

    @torch.no_grad()
    def logits(self, prompt: Sequence[int], served: Sequence[int], chunk: Optional[int],
               Lt: int) -> torch.Tensor:
        """Logits (T, V) f32 at the positions that produced the T served
        tokens: the prompt's last, then each served token but the last."""
        m, W, dev = self.m, self.w, self.w["embed"].device
        ids = torch.as_tensor(np.concatenate([np.asarray(prompt), np.asarray(served[:-1])]),
                              dtype=torch.long, device=dev)
        n, N = len(prompt), ids.numel()
        nh, nk, dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
        G, eps = nh // nk, float(m["rms_norm_eps"])
        cos, sin = rope_cos_sin(float(m["rope_theta"]), dh, N, dev)
        blocks = attention_blocks(n, N, chunk, Lt)
        lay = W["layers"]
        x = W["embed"][ids].float()
        for i in range(m["num_hidden_layers"]):
            h = rms_norm(x, lay["attn_norm"][i], eps)
            q = self._lin(h, lay["wq"][i], lay["bq"][i] if "bq" in lay else None).view(N, nh, dh)
            k = self._lin(h, lay["wk"][i], lay["bk"][i] if "bk" in lay else None).view(N, nk, dh)
            v = self._lin(h, lay["wv"][i], lay["bv"][i] if "bv" in lay else None).view(N, nk, dh)
            del h
            q, k = rope(q, cos, sin), rope(k, cos, sin)
            ko = self.t["k_outlier_idx"][i] if "k_outlier_idx" in self.t else None
            vo = self.t["v_outlier_idx"][i] if "v_outlier_idx" in self.t else None
            k_hat = pq_roundtrip(k, self.t["key"][i], ko)
            v_hat = pq_roundtrip(v, self.t["value"][i], vo)
            out = torch.empty(N, nh, dh, device=dev)
            for qs, qe, b in blocks:
                keys = torch.cat([k_hat[:b], k[b:qe]]).repeat_interleave(G, dim=1)
                vals = torch.cat([v_hat[:b], v[b:qe]]).repeat_interleave(G, dim=1)
                mask = torch.arange(qe, device=dev)[None, :] <= torch.arange(qs, qe, device=dev)[:, None]
                o = F.scaled_dot_product_attention(q[qs:qe].transpose(0, 1)[None],
                                                   keys.transpose(0, 1)[None],
                                                   vals.transpose(0, 1)[None], attn_mask=mask)
                out[qs:qe] = o[0].transpose(0, 1)
                del keys, vals, mask, o
            del q, k, v, k_hat, v_hat
            x = x + self._lin(out.view(N, nh * dh), lay["wo"][i])
            del out
            for s in range(0, N, ROW_BLOCK):
                hb = rms_norm(x[s:s + ROW_BLOCK], lay["mlp_norm"][i], eps)
                a = F.silu(self._lin(hb, lay["w_gate"][i], transpose=False))
                a = a * self._lin(hb, lay["w_up"][i], transpose=False)
                x[s:s + ROW_BLOCK] += self._lin(a, lay["w_down"][i], transpose=False)
                del hb, a
        h = rms_norm(x[n - 1:], W["final_norm"], eps)
        head = W["embed"] if m["tie_word_embeddings"] else W["lm_head"]
        return self._lin(h, head, transpose=m["tie_word_embeddings"])
