// PQ decode attention over one layer of paged, token-major code pools: the
// attention of a continuous-batching decode tick, every sequence slot with
// its own length and its own pages.
//
// Replaces the TPU kernels of million_tpu/ops/pq_attention_pallas.py:
//   pq_paged_attention_stacked (_pq_paged_attn_kernel_stacked), the serving
//     tick's kernel, outlier page pools included;
//   pq_paged_attention (_pq_paged_attn_kernel), through a one-layer view;
//   pq_paged_attention_stacked_mp (_pq_paged_attn_kernel_stacked_mp), as the
//     fixed-split mode: `fixed_chunk` = pages per block x page_size.
//
// What it computes, for each (sequence b, KV head h): the partial attention
// of the G pre-scaled query rows over tokens [0, n_codes[b]) of the layer,
// token t read at pool[page_table[b, t / page_size], h, t % page_size]:
//   s[g, t] = sum_m q[g, dims(m)] . kcent[m, kcode[t, m]] + q[g, koidx] . kout[t, :]
//   out[g]  = softmax_t(s[g]) @ V_hat, V decoded on the fly from vcent, the
//             exact bf16 channels vout[t, :] written over dims voidx,
// LSE-merged across the splits and, when the residual windows are given, with
// the exact partial over the first r[b] rows of sequence b's window (the
// whole attention of the tick). out (S, nh_k, G, d) f32, lse (S, nh_k, G)
// f32; n_codes[b] == 0 and r[b] == 0 give out = 0 and lse = -1e30, never NaN
// (inactive slots run in lockstep with the live ones).
//
// Design. The three passes of pq_attention_passes.cuh (score, value, reduce)
// instantiated with PAGED = true. What the TPU kernel gets from scalar
// prefetch and a sequential grid over pages is done by the block itself:
//   - the lengths live on the card. The host sizes the grid from a bound it
//     owns (pages allocated x page_size); each block reads n_codes[b] and
//     cuts ITS sequence into the S splits, so a short sequence beside a long
//     one still spreads over S blocks and the tick reads nothing back;
//   - a block walks its split a tile of 256 tokens at a time and looks the
//     tile's page up in the table (page_size % 256 == 0: no tile straddles a
//     page; -1 entries clamp to page 0 and lie beyond n_codes[b]). The next
//     tile's rows are staged with cp.async while this one is computed, across
//     page boundaries like any other tile: pages are never gathered into a
//     flat arena;
//   - the reduce pass takes one residual row count per sequence from device
//     memory, so the tick needs no separate residual partial and merge.
//
// Bound. Bytes: the codes and exact outlier channels of the live tokens,
// sum_b n_codes[b] x nh_k x (M + M_v + 2 (OK + OV)), read once: 128 B per
// token and KV head in dm2 and in dm4 with 16 + 16 outlier channels, so six
// slots of 32,640 tokens and 8 KV heads are 200.5 MB, 0.060 ms at 3.35 TB/s.
// As in the flat kernel the design is bound by neither bytes nor operations
// but by the latency of its passes (pq_decode_attention.cu says how the time
// splits).

#include "pq_attention_passes.cuh"

extern "C" int pq_paged_attention_tile() { return TILE; }

// Launches the score, value and reduce kernels on `stream`. kpool / vpool
// (and kopool / vopool) are ONE layer of the pools, (pages, nh_k, page_size,
// M | M_v | OK | OV). seq_r (bs,) int32 gives each sequence's live residual
// rows when kres / vres (bs, nh_k, Lt, d; bf16 when res_bf16 else f32) are
// given, else all three are null. `scores` (bs * nh_k * n_bound * G f32) and
// `ml_part` (bs * nh_k * S * G * 2 f32) are scratch. Returns a cudaError_t
// (0 on success); the caller validates shapes and types and chooses the
// passes' builds: kwide / vwide 1 for the score / value pass that takes any
// subspace width and count (d_m > 8, or M % 4 != 0), 0 for the d_m <= 8 one.
extern "C" int pq_paged_attention(
    const void* q, const void* kpool, const void* vpool,
    const void* kcent, const void* vcent,
    const void* kopool, const void* vopool, const void* koidx, const void* voidx,
    const void* kres, const void* vres,
    const void* page_table, const void* seq_n_codes, const void* seq_r,
    void* scores, void* ml_part, void* out_part, void* lse_part, void* out, void* lse,
    int bs, int nh_k, int G, int d, int M, int Ck, int Mv, int Cv, int OK, int OV,
    int P_max, int page_size, int n_bound, int S, int fixed_chunk, int Lt, int res_bf16, int kwide,
    int vwide,
    void* stream) {
  if (page_size % TILE || n_bound > P_max * page_size) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = (const float*)q;
  p.kcodes = (const uint8_t*)kpool;
  p.vcodes = (const uint8_t*)vpool;
  p.kcent = (const float*)kcent;
  p.vcent = (const float*)vcent;
  p.kout = (const __nv_bfloat16*)kopool;
  p.vout = (const __nv_bfloat16*)vopool;
  p.koidx = (const int*)koidx;
  p.voidx = (const int*)voidx;
  p.scores = (float*)scores;
  p.ml_part = (float*)ml_part;
  p.out_part = (float*)out_part;
  p.lse_part = (float*)lse_part;
  p.nh_k = nh_k; p.d = d; p.M = M; p.Ck = Ck; p.dmk = d / M;
  p.Mv = Mv; p.Cv = Cv; p.dmv = d / Mv; p.OK = OK; p.OV = OV;
  p.kwide = kwide; p.vwide = vwide;
  p.S = S; p.srow_len = n_bound;
  p.page_table = (const int*)page_table;
  p.seq_n_codes = (const int*)seq_n_codes;
  p.P_max = P_max; p.page_size = page_size; p.n_bound = n_bound; p.fixed_chunk = fixed_chunk;
  return run_passes<true>(p, bs, G, kres, vres, 0, (const int*)seq_r, Lt, res_bf16, (float*)out,
                          (float*)lse, (cudaStream_t)stream);
}
