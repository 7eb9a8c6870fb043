// PQ decode attention over one layer of a flat, token-major code arena.
//
// Replaces the TPU kernel million_tpu/ops/pq_attention_pallas.py::
// pq_codes_attention_stacked (_pq_attn_kernel_stacked + _make_block_step)
// and, through a one-layer view, pq_codes_attention (_pq_attn_kernel).
//
// What it computes, for each (sequence b, KV head h): the G pre-scaled query
// rows of the GQA group attend over the first n_codes quantized tokens.
//   s[g, n] = sum_m q[g, dims(m)] . kcent[m, kcode[n, m]]      (strided split:
//             subspace m owns dims {m, m + M, m + 2M, ...})
//           + q[g, koidx] . kout[n, :]                          (outlier mode)
//   out[g]  = softmax_n(s[g]) @ V_hat,  V_hat decoded from vcent with M_v
//             subspaces; in outlier mode the exact bf16 channels vout[n, :]
//             take the place of dims voidx (their centroid components are 0).
// It returns the normalised partial (bs, nh_k, G, d) f32 in natural head
// order and its log-sum-exp (bs, nh_k, G); an empty partial has lse = -1e30.
// With the residual window given, the exact partial over its first r rows
// is LSE-merged in as well (the whole decode-step attention).
//
// Design. Three launches (the device code is in pq_attention_passes.cuh,
// which pq_paged_attention.cu instantiates for page pools). The token axis
// is cut into splits so that a batch of one still fills the 132 SMs, and
// blocks are (split, KV head, sequence).
//   pq_score_kernel: the scores of every token (f32, to a scratch row per
//     (b, h)) and each split's softmax max and sum, with the K codebook in
//     shared memory.
//   pq_value_kernel: P @ V per split from those scores, with the V codebook
//     in shared memory, V decoded on the fly.
//   pq_reduce_kernel: the LSE-merge of the splits and of the residual window
//     (the reference's split + reduce pair, SURVEY.md 2.2 C1-C3).
// Splitting K and V into two passes costs one write and one read of the f32
// scores (12 B per token at G=3, against 128 B of codes) and buys room: one
// f32 codebook is C * d * 4 bytes (128 KB at C=256, d=128), and two of them
// do not fit in the 227 KB of shared memory beside the code tiles. In each
// pass the tiles of code rows (and outlier rows, and scores) are copied into
// shared memory with cp.async, double-buffered, so the next tile's copy is in
// flight while the current one is computed. All arithmetic is f32, so the
// kernel differs from its plain PyTorch version only by summation order.
//
// Bound. Per call the kernel must read the codes and outlier slabs of
// n_codes tokens: with M = M_v = 64 (dm2) or M = M_v = 32 plus 16 + 16 bf16
// outlier channels (dm4_outlier), both 128 B per token per (b, h). At 32K
// tokens that is ~4.2 MB per (b, h) and ~33.5 MB per sequence and layer over
// 8 KV heads, ~10 us at 3.35 TB/s. The f32 FMAs (4 * G * d per token) bound
// it from below too; chip_smoke.py prints both for the shapes it runs. This
// design is bound by neither: knock-out builds (benchmarks/paged_kernel_ab.py)
// put ~55 % of its time in the score pass and ~35 % in the value pass, of
// which the centroid gathers are a fifth and a twentieth; the rest is the
// latency of one 512-thread block per SM working through its tiles.

#include "pq_attention_passes.cuh"

extern "C" int pq_decode_attention_tile() { return TILE; }

// Launches the score, value and reduce kernels on `stream`; with r > 0 the
// reduce also merges in the exact partial over the first r rows of the
// residual window (kres/vres, Lt rows, bf16 when res_bf16 else f32).
// `scores` (bs * nh_k * S * chunk * G f32) and `ml_part` (bs * nh_k * S * G
// * 2 f32) are scratch. Returns a cudaError_t (0 on success); the caller
// validates shapes and types.
extern "C" int pq_decode_attention(
    const void* q, const void* kcodes, const void* vcodes,
    const void* kcent, const void* vcent,
    const void* kout, const void* vout, const void* koidx, const void* voidx,
    const void* kres, const void* vres,
    void* scores, void* ml_part, void* out_part, void* lse_part, void* out, void* lse,
    int bs, int nh_k, int G, int d, int M, int Ck, int Mv, int Cv, int OK, int OV,
    int N_max, int n_codes, int S, int chunk, int r, int Lt, int res_bf16, void* stream) {
  Params p = {};
  p.q = (const float*)q;
  p.kcodes = (const uint8_t*)kcodes;
  p.vcodes = (const uint8_t*)vcodes;
  p.kcent = (const float*)kcent;
  p.vcent = (const float*)vcent;
  p.kout = (const __nv_bfloat16*)kout;
  p.vout = (const __nv_bfloat16*)vout;
  p.koidx = (const int*)koidx;
  p.voidx = (const int*)voidx;
  p.scores = (float*)scores;
  p.ml_part = (float*)ml_part;
  p.out_part = (float*)out_part;
  p.lse_part = (float*)lse_part;
  p.nh_k = nh_k; p.d = d; p.M = M; p.Ck = Ck; p.dmk = d / M;
  p.Mv = Mv; p.Cv = Cv; p.dmv = d / Mv; p.OK = OK; p.OV = OV;
  p.N_max = N_max; p.n_codes = n_codes; p.S = S; p.chunk = chunk;
  p.srow_len = S * chunk;
  return run_passes<false>(p, bs, G, kres, vres, r, nullptr, Lt, res_bf16, (float*)out,
                           (float*)lse, (cudaStream_t)stream);
}
