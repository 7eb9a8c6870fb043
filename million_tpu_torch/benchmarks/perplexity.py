"""Teacher-forced perplexity with a quantized history.

Counterpart of million_tpu/benchmarks/perplexity.py, with its protocol: the
token stream is cut into non-overlapping windows of `max_length`, each window
runs a prefill on a fresh cache, and in PQ mode `distort_recent=True` replaces
K/V with decode(encode(.)) so the loss reflects a fully quantized history.
The stream goes to the device the parameters are on.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from million_tpu_torch.models import llama


@torch.no_grad()
def _nll_from_hidden(params, cfg: llama.ModelConfig, x: torch.Tensor, tgt: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """Teacher-forced sum NLL (f32 scalar) from pre-head hidden states x (bs,
    n, D) and targets tgt (bs, n - 1) of positions [0, n - 1), projecting
    `chunk` positions at a time: the logit transient is (bs, chunk, V), not
    (bs, n, V). The last chunk is sliced short rather than padded, so no
    position past n - 1 is ever scored."""
    nt = x.shape[1] - 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, nt, chunk):
        e = min(s + chunk, nt)
        logp = F.log_softmax(llama._logits(params, cfg, x[:, s:e]).to(torch.float32), dim=-1)
        total += -logp.gather(-1, tgt[:, s:e, None].long()).sum()
    return total


@torch.no_grad()
def window_nll(params, cfg: llama.ModelConfig, ids: torch.Tensor, cache, cents, mode: str,
               distort_recent: bool, use_kernel: bool = True) -> tuple[float, int]:
    """Sum NLL (nats) of predicting ids[:, 1:] from ids[:, :-1], and the token count."""
    x = llama.prefill(params, cfg, ids, cache, cents, mode=mode, distort_recent=distort_recent,
                      return_hidden=True, use_kernel=use_kernel)
    tgt = ids[:, 1:]
    # chunk so the (bs, chunk, V) logit transient stays ~256 MB f32
    chunk = min(max(256, (1 << 26) // max(cfg.vocab_size, 1)), ids.shape[1])
    return float(_nll_from_hidden(params, cfg, x, tgt, chunk)), int(tgt.numel())


@torch.no_grad()
def perplexity(
    params,
    cfg: llama.ModelConfig,
    tokens: np.ndarray,  # 1-D token stream
    make_cache: Callable[[], Any],  # () -> a fresh cache on the parameters' device
    cents: Optional[Dict[str, torch.Tensor]],
    *,
    mode: str = "pq",
    max_length: int = 2048,
    distort_recent: bool = True,
    max_windows: Optional[int] = None,
    use_kernel: bool = True,  # False: the prefill encode's plain version
) -> Dict[str, Any]:
    """ppl over the stream's first windows. Mode "pq_kernel" maps to "pq":
    decode modes share one prefill path."""
    tokens = np.asarray(tokens, np.int64)
    n_windows = len(tokens) // max_length
    if max_windows is not None:
        n_windows = min(n_windows, max_windows)
    if n_windows == 0:
        raise ValueError(f"stream of {len(tokens)} tokens < max_length {max_length}")
    dev = params["embed"].device
    prefill_mode = "pq" if mode == "pq_kernel" else mode
    total_nll, total_cnt = 0.0, 0
    for w in range(n_windows):
        ids = torch.from_numpy(tokens[w * max_length:(w + 1) * max_length][None, :]).to(dev)
        nll, cnt = window_nll(params, cfg, ids, make_cache(), cents, prefill_mode,
                              distort_recent and mode != "dense", use_kernel)
        total_nll += nll
        total_cnt += cnt
    return {"ppl": float(np.exp(total_nll / total_cnt)), "nll_per_token": total_nll / total_cnt,
            "windows": n_windows}
