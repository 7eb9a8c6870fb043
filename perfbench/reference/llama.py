"""The llama-class decoder (GQA, RoPE, RMSNorm, SwiGLU, optional q/k/v
biases) served from a product-quantized KV cache in every layer: the plain
side of the architecture "llama", in plain PyTorch, importing nothing of the
program.

What the served path computes, written out: a query at position t attends
keys and values reconstructed from their PQ codes (nearest centroid in each
subspace, subspace m owning head dims m, m + M, ...; the exact outlier
channels kept as they are) at positions before b(t), and exact ones from
b(t) to t. For a prompt admitted in chunks of c tokens b(t) = c * floor(t /
c) (one-shot: 0); for a decoded token b(t) = n4 + Lt * floor((t - n4) / Lt),
n4 the prompt length rounded down to a multiple of 4 and Lt the residual
window, since a full window is encoded before the next token. The codes are
worked out here from the reference's own keys and values. Products follow
common.matmul (exact f32, or the fp8 control).

Weights follow the published widths of the configuration, in the layout the
port's model takes (a dict; per-layer weights stacked on a leading layer
axis, attention projections stored (out, in), MLP weights (in, out)): normal
with std sqrt(2 / (fan_in + fan_out)) over the last two axes, norms at 1,
drawn in the served type in one call per stacked tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.inputs import DTYPES, torch_seed
from perfbench.reference.common import (ROW_BLOCK, attention_blocks, matmul, pq_roundtrip, rms_norm, rope,
                                        rope_cos_sin)


def make_weights(m: dict, ss: np.random.SeedSequence, device: torch.device) -> Dict:
    gen = torch.Generator(device=device).manual_seed(torch_seed(ss))
    dt = DTYPES[m["torch_dtype"]]
    L, D, I, V = m["num_hidden_layers"], m["hidden_size"], m["intermediate_size"], m["vocab_size"]
    nh, nk, dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]

    def w(*shape):
        std = (2.0 / (shape[-2] + shape[-1])) ** 0.5
        return torch.randn(shape, generator=gen, device=device, dtype=dt).mul_(std)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dt)

    params = {
        "embed": w(V, D),
        "final_norm": ones(D),
        "layers": {
            "attn_norm": ones(L, D), "mlp_norm": ones(L, D),
            "wq": w(L, nh * dh, D), "wk": w(L, nk * dh, D), "wv": w(L, nk * dh, D),
            "wo": w(L, D, nh * dh),
            "w_gate": w(L, D, I), "w_up": w(L, D, I), "w_down": w(L, I, D),
        },
    }
    if m.get("attention_bias"):
        params["layers"].update(bq=w(L, nh * dh), bk=w(L, nk * dh), bv=w(L, nk * dh))
    if not m["tie_word_embeddings"]:
        params["lm_head"] = w(D, V)
    return params


def pq_layers(m: dict) -> List[int]:
    """The layers whose keys and values live in the PQ pool: every layer."""
    return list(range(m["num_hidden_layers"]))


def matmul_params(m: dict) -> int:
    """Weights a token multiplies through in the transformer body (the head
    apart): q, k, v, o and the three MLP projections of every layer."""
    D, I, L = m["hidden_size"], m["intermediate_size"], m["num_hidden_layers"]
    nh, nk, dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    return L * (D * (nh + 2 * nk) * dh + nh * dh * D + 3 * D * I)


def token_flops(m: dict, context: int, head: bool) -> int:
    """Dense-model operations of one token that attends `context` keys: 2 x
    the matmul weights it touches (the head when its logits are computed),
    plus 4 x layers x heads x head_dim x context for the scores and P @ V."""
    w = matmul_params(m) + (m["hidden_size"] * m["vocab_size"] if head else 0)
    return 2 * w + 4 * m["num_hidden_layers"] * m["num_attention_heads"] * m["head_dim"] * context


def prompt_flops(m: dict, n: int) -> int:
    """token_flops summed over an n-token prompt admitted at once: token p
    attends p + 1 keys, and only the last token's logits are computed."""
    attn = 4 * m["num_hidden_layers"] * m["num_attention_heads"] * m["head_dim"]
    return 2 * matmul_params(m) * n + attn * n * (n + 1) // 2 + 2 * m["hidden_size"] * m["vocab_size"]


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
