"""Product-quantizer codebook training: Lloyd k-means over all subspaces at once.

Counterpart of million_tpu/pq/kmeans.py, with the same algorithm:
  * k-means++ (D^2-sampling) init on at most 2^17 evenly strided points;
  * Lloyd iterations, 25 by default (faiss's niter in the reference);
  * empty clusters re-seeded at the worst-served points;
  * above n * C * M = 2^28 the large-n step, whose empty-cluster donors come
    from an evenly strided subsample of at most 2^17 rows.

Where the reference vmaps one subspace's k-means over the M subspaces, every
function here takes all M at once: samples `xs` (n, M, d_m) f32, codebooks
`cents` (M, C, d_m). The assignment of a Lloyd step, argmin_c ||c||^2 -
2 <x_m, c> with ties to the lowest index, is the fused encode's function: on
a CUDA tensor it launches that kernel (ops/pq_encode_kernel.py, "exact"), which
never writes the (n, M, C) distances; on the CPU, or with use_kernel=False,
it is the plain matmul plus argmin (pq/ops.pq_encode) over row chunks. The
update sums with index_add_. Codes are uint8 up to C = 256 and int16 above
(the encode's wide build), read back as int64 indices (pq/ops.code_index)
before they index the statistics.

jax.random keys become one torch.Generator per call, seeded from `seed` on the
samples' device: the two draw different points, so `lloyd` starts from given
centroids and the tests hand it the reference's k-means++ output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from million_tpu_torch.ops.pq_encode_kernel import pq_encode_fused
from million_tpu_torch.pq.ops import code_index, pq_decode, pq_encode, subspace_view

INIT_CAP = 1 << 17  # k-means++ draws from at most this many strided points
SUB_CAP = 1 << 17  # the large-n step's donor pool
LARGE_N = 1 << 28  # n * C * M above which train_pq takes the large-n step


def _rows(xs: torch.Tensor) -> torch.Tensor:
    """(n, M, d_m) -> (n, M * d_m), the contiguous subspace layout."""
    return xs.reshape(xs.shape[0], -1)


def _assign(xs: torch.Tensor, cents: torch.Tensor, chunk_n: int = 0) -> torch.Tensor:
    """Plain assignment: xs (n, M, d_m), cents (M, C, d_m) -> (n, M) codes
    (uint8, or int16 above C = 256) of the nearest centroid, a batched matmul plus argmin. chunk_n > 0
    bounds the distance block to (M, chunk_n, C)."""
    x = _rows(xs)
    n = x.shape[0]
    if chunk_n <= 0 or n <= chunk_n:
        return pq_encode(x, cents, "contiguous", precision="exact")
    return torch.cat([pq_encode(x[s:s + chunk_n], cents, "contiguous", precision="exact")
                      for s in range(0, n, chunk_n)])


def assign(xs: torch.Tensor, cents: torch.Tensor, chunk_n: int = 0,
           use_kernel: bool = True) -> torch.Tensor:
    """Nearest centroid of every row and subspace -> (n, M) codes: the fused
    encode kernel for a CUDA tensor (use_kernel), else `_assign`."""
    if use_kernel and xs.device.type == "cuda":  # every d_m and C: the kernel encode_route picks
        return pq_encode_fused(_rows(xs), cents, "contiguous", precision="exact")
    return _assign(xs, cents, chunk_n)


def _flat_index(codes: torch.Tensor, C: int) -> torch.Tensor:
    """(n, M) codes -> (n * M,) rows of the (M * C, ...) statistics."""
    M = codes.shape[1]
    return (code_index(codes) + torch.arange(M, device=codes.device) * C).reshape(-1)


def _update(xs: torch.Tensor, codes: torch.Tensor, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of the rows assigned to each centroid -> (cents (M, C, d_m),
    counts (M, C)); an empty cluster's mean is 0."""
    n, M, d_m = xs.shape
    idx = _flat_index(codes, C)
    counts = torch.zeros(M * C, dtype=torch.float32, device=xs.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    sums = torch.zeros((M * C, d_m), dtype=torch.float32, device=xs.device)
    sums.index_add_(0, idx, xs.reshape(n * M, d_m))
    counts = counts.reshape(M, C)
    return sums.reshape(M, C, d_m) / counts.clamp(min=1.0)[..., None], counts


def _gather_rows(xs: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """xs (n, M, d_m), order (M, k) row indices per subspace -> (M, k, d_m)."""
    M = xs.shape[1]
    return xs[order, torch.arange(M, device=xs.device)[:, None]]


def _fill_empty(cents: torch.Tensor, counts: torch.Tensor, donors: torch.Tensor) -> torch.Tensor:
    """The j-th empty cluster of a subspace takes its j-th donor (M, C, d_m)."""
    C = cents.shape[1]
    empty = counts == 0
    rank = torch.cumsum(empty.to(torch.int64), dim=1) - 1
    slot = torch.gather(donors, 1, rank.clamp(0, C - 1)[..., None].expand_as(cents))
    return torch.where(empty[..., None], slot, cents)


def _split_empty(xs: torch.Tensor, codes: torch.Tensor, cents: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """Re-seed empty clusters at the rows worst served by their assigned
    centroid (largest distance), one row per empty cluster in order."""
    C = cents.shape[1]
    d2 = (xs - cents[torch.arange(xs.shape[1], device=xs.device), code_index(codes)]).square().sum(-1)
    order = torch.topk(d2.t(), C, dim=1).indices  # (M, C) worst-served rows
    return _fill_empty(cents, counts, _gather_rows(xs, order))


def _kmeanspp_init(xs: torch.Tensor, C: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ init of every subspace: xs (n, M, d_m) -> (M, C, d_m).

    Each next centroid is drawn with probability proportional to its squared
    distance to the nearest one already chosen, so a row at distance 0 is
    never drawn (a subspace whose rows are all covered draws uniformly). The
    draw runs on at most INIT_CAP evenly strided rows; Lloyd then runs on
    all of them. No draw reads anything back to the host."""
    n, M, _ = xs.shape
    if n > INIT_CAP:
        xs = xs[::n // INIT_CAP][:INIT_CAP]
        n = xs.shape[0]
    xm = xs.transpose(0, 1).contiguous()  # (M, n, d_m)
    ar = torch.arange(M, device=xs.device)
    first = torch.randint(0, n, (M,), generator=generator, device=xs.device)
    cents = torch.empty((M, C, xs.shape[2]), dtype=torch.float32, device=xs.device)
    cents[:, 0] = xm[ar, first]
    min_d2 = (xm - cents[:, :1]).square().sum(-1)  # (M, n)
    for c in range(1, C):
        w = torch.where(min_d2.sum(-1, keepdim=True) > 0, min_d2, torch.ones_like(min_d2))
        # torch.multinomial(w, 1)'s own draw, argmax of w / Exp(1) noise (the same numbers from
        # the same generator), without its two host reads of validity checks per draw: the
        # C - 1 draws queue on the device with no synchronisation
        q = torch.empty_like(w).exponential_(1.0, generator=generator)
        pick = torch.argmax(w / q, dim=-1)
        cents[:, c] = xm[ar, pick]
        min_d2 = torch.minimum(min_d2, (xm - cents[:, c:c + 1]).square().sum(-1))
    return cents


def _lloyd_iter(xs: torch.Tensor, cents: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """One Lloyd step: assign, average, keep the old centroid of an empty
    cluster, then re-seed it (`_split_empty`)."""
    codes = assign(xs, cents, use_kernel=use_kernel)
    new, counts = _update(xs, codes, cents.shape[1])
    new = torch.where((counts == 0)[..., None], cents, new)
    return _split_empty(xs, codes, new, counts)


def _lloyd_iter_large(xs: torch.Tensor, xs_sub: torch.Tensor, cents: torch.Tensor,
                      chunk_n: int, use_kernel: bool) -> torch.Tensor:
    """One Lloyd step of the large-n regime: the plain assignment runs over
    row chunks of chunk_n, and empty clusters re-seed at the rows of the
    subsample xs_sub (ns, M, d_m) farthest from their nearest NEW centroid."""
    C = cents.shape[1]
    codes = assign(xs, cents, chunk_n, use_kernel)
    new, counts = _update(xs, codes, C)
    new = torch.where((counts == 0)[..., None], cents, new)
    d2 = _nearest_d2(xs_sub, new, chunk_n, use_kernel)  # (ns, M)
    ns = xs_sub.shape[0]
    order = torch.topk(d2.t(), min(C, ns), dim=1).indices
    donors = _gather_rows(xs_sub, order)
    if ns < C:
        donors = torch.cat([donors, donors.new_zeros((donors.shape[0], C - ns, donors.shape[2]))], 1)
    return _fill_empty(new, counts, donors)


def _nearest_d2(xs: torch.Tensor, cents: torch.Tensor, chunk_n: int, use_kernel: bool) -> torch.Tensor:
    """Squared distance of every row and subspace to its nearest centroid (n, M)."""
    codes = assign(xs, cents, chunk_n, use_kernel)
    near = cents[torch.arange(xs.shape[1], device=xs.device), code_index(codes)]  # (n, M, d_m)
    return (xs - near).square().sum(-1)


def _inertia_large(xs: torch.Tensor, cents: torch.Tensor, chunk_n: int = 0,
                   use_kernel: bool = True) -> torch.Tensor:
    """Sum of squared distances to the nearest centroid, per subspace (M,)."""
    return _nearest_d2(xs, cents, chunk_n, use_kernel).sum(0)


def lloyd(xs: torch.Tensor, cents: torch.Tensor, iters: int = 25, *, chunk_n: int = 0,
          xs_sub: Optional[torch.Tensor] = None, use_kernel: bool = True) -> torch.Tensor:
    """`iters` Lloyd steps from the centroids given: xs (n, M, d_m) f32, cents
    (M, C, d_m) -> (M, C, d_m). A donor pool xs_sub, or chunk_n > 0 with
    n > chunk_n (then the pool is xs itself, as the reference's
    single-subspace `kmeans` passes), takes the large-n step."""
    cents = cents.to(torch.float32).contiguous()
    large = xs_sub is not None or 0 < chunk_n < xs.shape[0]
    for _ in range(iters):
        if large:
            cents = _lloyd_iter_large(xs, xs if xs_sub is None else xs_sub, cents, chunk_n, use_kernel)
        else:
            cents = _lloyd_iter(xs, cents, use_kernel)
    return cents


def kmeans(x: torch.Tensor, C: int, iters: int = 25, seed: int = 0,
           chunk_n: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-subspace k-means: x (n, k) -> (centroids (C, k), inertia)."""
    xs = x.to(torch.float32)[:, None, :]
    g = torch.Generator(device=x.device).manual_seed(seed)
    cents = lloyd(xs, _kmeanspp_init(xs, C, g), iters, chunk_n=chunk_n)
    return cents[0], _inertia_large(xs, cents, chunk_n)[0]


def large_n_chunk(M: int, C: int) -> int:
    """Row chunk of the large-n step's plain assignment: (M, chunk, C) f32
    distances of at most 512 MB."""
    return max(512, (1 << 27) // (M * C) // 8 * 8)


def train_pq(
    samples: torch.Tensor,
    M: int,
    nbits: int = 8,
    iters: int = 25,
    seed: int = 0,
    layout: str = "contiguous",
) -> torch.Tensor:
    """Train the PQ codebooks on samples' device: samples (n, d) -> cents (M,
    C=2^nbits, d/M) f32. All subspaces train together; above n * C * M =
    LARGE_N the large-n step with its strided donor pool."""
    n, d = samples.shape
    if d % M != 0:
        raise ValueError(f"d={d} not divisible by M={M}")
    C = 2**nbits
    if n < C:
        raise ValueError(f"need at least C={C} samples, got {n}")
    xs = subspace_view(samples.to(torch.float32), M, layout).contiguous()  # (n, M, d_m)
    g = torch.Generator(device=samples.device).manual_seed(seed)
    cents = _kmeanspp_init(xs, C, g)
    if n * C * M <= LARGE_N:
        return lloyd(xs, cents, iters)
    xs_sub = xs[::max(n // SUB_CAP, 1)][:SUB_CAP] if n > SUB_CAP else xs
    return lloyd(xs, cents, iters, chunk_n=large_n_chunk(M, C), xs_sub=xs_sub)


def train_opq(
    samples: torch.Tensor,
    M: int,
    nbits: int = 8,
    iters: int = 25,
    opq_iters: int = 10,
    seed: int = 0,
    layout: str = "contiguous",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimized PQ (OPQ-NP, the alternation faiss's OPQMatrix runs): learn
    an orthogonal R minimising the PQ reconstruction error of X @ R, then
    codebooks on the rotated data. Returns (R (d, d), cents (M, 2^nbits,
    d/M)); encode x @ R, reconstruct pq_decode(...) @ R.T.

        repeat: train PQ on X @ R  ->  X_hat = decode(encode(X @ R))
                R <- U V^T from SVD(X^T X_hat)   (orthogonal Procrustes)
    """
    X = samples.to(torch.float32)
    d = X.shape[1]
    R = torch.eye(d, dtype=torch.float32, device=X.device)
    inner_iters = max(4, iters // 4)  # cheap inner PQ during the alternation
    for it in range(opq_iters):
        XR = X @ R
        cents = train_pq(XR, M, nbits, iters=inner_iters, seed=seed + it, layout=layout)
        codes = assign(subspace_view(XR, M, layout).contiguous(), cents)
        X_hat = pq_decode(codes, cents, layout)
        u, _, vt = torch.linalg.svd(X.t() @ X_hat, full_matrices=False)
        R = u @ vt
    cents = train_pq(X @ R, M, nbits, iters=iters, seed=seed, layout=layout)
    return R, cents
