"""The yardstick's arithmetic: the card's published peaks and the least time
a kernel call can take at its shapes. The model's own operations are its
architecture's (reference/<architecture>.py: token_flops, prompt_flops).

The byte and operation counts are those the port's own kernel notes state
(ops/pq_paged_attention_kernel.py::paged_bytes / paged_flops,
ops/pq_chunk_attention_kernel.py::chunk_bytes / chunk_ops, as chip_smoke.py
uses them), copied here so that a change to the program cannot move the
yardstick. Each input byte is counted once and each output byte once.
"""

from __future__ import annotations

from typing import Optional, Sequence

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense tensor-core bf16 and
# f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time a call can take: the larger of its bytes over the
    memory rate and its operations over the peak rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def decode_row_ops(n: int, d: int, OK: int = 0, OV: int = 0, M: Optional[int] = None,
                   M_v: Optional[int] = None, C: Optional[int] = None,
                   C_v: Optional[int] = None) -> int:
    """Operations for one query row over n quantized tokens (an f32 FMA is 2):
    each side counts the fewer of the direct decode (2 n d) and the table
    route (q against every centroid, 2 C d, then one add a subspace and
    token), the value side's OV exact channels 2 a token, the key side's OK
    exact channels 2 a token."""
    key = val = 2 * n * d
    if M is not None:
        key = min(key, 2 * C * d + n * M)
    if M_v is not None:
        val = min(val, 2 * C_v * (d - OV) + n * (M_v + 2 * OV))
    return key + 2 * n * OK + val


def paged_call(n_codes: Sequence[int], rows: Sequence[int], *, nh_k: int, G: int, d: int, M: int,
               C: int, O: int, res_itemsize: int = 2) -> tuple:
    """(bytes, operations) of one layer's paged decode attention (B4) over
    the slots given: n_codes[b] quantized tokens and rows[b] exact residual
    rows each. Bytes: the codes and exact channels of each slot's tokens, its
    live residual rows (k and v), the two codebooks, q read and out and lse
    written in f32. Operations: decode_row_ops over the codes plus the
    direct product over the residual rows, per query row."""
    S = len(n_codes)
    codes = sum(int(n) for n in n_codes) * nh_k * (2 * M + 2 * 2 * O)
    resid = sum(int(r) for r in rows) * nh_k * 2 * d * res_itemsize
    books = 2 * M * C * (d // M) * 4
    qo = S * nh_k * G * (2 * d + 1) * 4
    ops = nh_k * G * sum(decode_row_ops(int(n), d, O, O, M, M, C, C) + 4 * int(r) * d
                         for n, r in zip(n_codes, rows))
    return codes + resid + books + qo, ops


def chunk_call(bs: int, QR: int, n_codes: int, *, nh_k: int, d: int, M: int, O: int) -> tuple:
    """(bytes, operations) of one chunk-history attention call (B3): bs
    slots, QR query rows a KV head (chunk rows x G), over n_codes quantized
    history tokens. Bytes: q read, out and lse written in f32, the codes and
    exact channels of the history read once. Operations: the score product
    over d + OK and P @ V over d, per row and token."""
    nbytes = bs * nh_k * (QR * (2 * d + 1) * 4 + n_codes * (2 * M + 2 * 2 * O))
    ops = 2 * bs * nh_k * QR * n_codes * (2 * d + O)
    return nbytes, ops
