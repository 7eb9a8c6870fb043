// Many-query partial attention of a prefill chunk over the quantized history.
//
// Replaces the TPU kernel million_tpu/ops/pq_attention_pallas.py::
// pq_chunk_attention (_pq_chunk_attn_kernel + _make_block_step), which
// pq_chunk_history_attention wraps for GQA.
//
// What it computes, for each (sequence b, KV head h): QR pre-scaled query
// rows (a chunk's positions times the GQA group) all attend over the same
// first n_codes quantized tokens of the arena, with no causal mask.
//   s[r, n] = q[r, :] . K_hat[n, :]  +  q[r, koidx] . kout[n, :]
//   out[r]  = softmax_n(s[r]) @ V_hat,   lse[r] = logsumexp_n s[r]
// K_hat and V_hat are decoded from the f32 codebooks with the strided
// subspace split (subspace m owns dims {m, m + M, ...}); in outlier mode the
// exact bf16 channels vout[n, :] take the place of dims voidx of V_hat. The
// normalised out (f32, natural head order) and lse are what the caller
// LSE-merges with the chunk's causal partial; n_codes = 0 gives out = 0 and
// lse = -1e30.
//
// Two versions of that function. The f32 version, first below, serves f32
// models and is the reference of the other. The tensor-core version, further
// down, serves 16-bit models: q, K_hat, V_hat and P are rounded to bf16 and
// every sum is f32, as the model's own attention products run on the card.
// Decoding K_hat and V_hat from the codebooks is about as much work as the
// products, so that version decodes on producer warpgroups while consumer
// warpgroups multiply on wgmma, and the two overlap instead of taking turns.
//
// Bound. 2 x rows x n_codes x (2 d + OK) operations: at bs = 4, 8 KV heads,
// 12,288 rows, 28,672 history tokens, d = 128, OK = 16 that is 6.1 TFLOP,
// 6.2 ms at the 989 TFLOP/s bf16 tensor-core peak (the card's bound for this
// product) and 92 ms at the 67 TFLOP/s f32 rate of the f32 version. The
// bytes (q, out, codes) are 0.5 GB, 0.15 ms.
//
// The f32 version. Blocks run in no order, so the TPU kernel's history axis
// of the grid becomes a loop: a block owns BQ = 128 query rows of one (b, h)
// and walks the history in tiles of BN = 128 tokens, carrying the
// online-softmax state (row max, row sum, the 128 x d accumulator) in
// registers. Rows are plentiful (12,288 per (b, h) at a 4096-token chunk with
// G = 3), so the history is not split and there is no reduce pass. Per tile:
//   1. decode K_hat of the tile into shared memory, k-major (Kt[k][token]),
//      with the exact K outlier rows as OK extra k rows; the matching extra
//      rows of the query tile hold q[:, koidx];
//   2. S = Q Kt as a register-tiled f32 product: 256 threads in a 16 x 16
//      grid, each an 8 x 8 micro-tile fed by 16-byte shared-memory reads
//      (64 FMAs per 4 reads); mask the ragged tail; online softmax with the
//      row reductions over the 16 lanes that share a row; P goes to shared
//      memory transposed (Pt[token][row]);
//   3. decode V_hat of the tile into the buffer K_hat occupied, token-major,
//      and write the exact V outlier channels over dims voidx;
//   4. acc += P V_hat, the same register tiling.
// The decode is shared by the 128 rows of the tile, so it is a few percent
// of the arithmetic. The f32 codebooks (128 KB a side at C = 256) stay in
// device memory and are gathered through L2: shared memory goes to the query
// tile (72 KB), the decoded tile (72 KB) and P (66 KB), one block per SM.
// All arithmetic of this version is f32, so it differs from its plain
// PyTorch version only by summation order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

#define BQ 128        // query rows per block
#define BN 128        // history tokens per tile
#define THREADS 256   // 16 x 16 threads, an 8 x 8 micro-tile each
#define LDQ BQ        // Qt[k][row]
#define LDK BN        // Kt[k][token]
#define LDV 128       // Vs[token][dim], d <= 128
#define LDP (BQ + 4)  // Pt[token][row], padded against store conflicts
#define NEG_BIG (-1e30f)

struct ChunkParams {
  const float* q;              // (bs, nh_k, QR, d) f32, pre-scaled
  const uint8_t* kcodes;       // (bs, nh_k, N_max, M) uint8
  const uint8_t* vcodes;       // (bs, nh_k, N_max, Mv) uint8
  const float* kcent;          // (M, Ck, dmk) f32
  const float* vcent;          // (Mv, Cv, dmv) f32
  const __nv_bfloat16* kout;   // (bs, nh_k, N_max, OK) bf16 or null
  const __nv_bfloat16* vout;   // (bs, nh_k, N_max, OV) bf16 or null
  const int* koidx;            // (OK,) int32 or null
  const int* voidx;            // (OV,) int32 or null
  float* out;                  // (bs, nh_k, QR, d) f32
  float* lse;                  // (bs, nh_k, QR) f32
  int nh_k, QR, d, M, Ck, dmk, Mv, Cv, dmv, OK, OV, N_max, n_codes;
};

// c[i][j] += a[i] * b[j] for the 8 x 8 micro-tile
__device__ __forceinline__ void outer8(float (&c)[8][8], const float4& a0, const float4& a1,
                                       const float4& b0, const float4& b1) {
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
}

// reductions over the 16 lanes (tx) that share a query row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS, 1) pq_chunk_attention_kernel(ChunkParams p) {
  extern __shared__ float4 smem4[];
  const int d = p.d, M = p.M, Mv = p.Mv, OK = p.OK, OV = p.OV;
  const int KD = d + OK;  // contraction length of the score product
  float* Qt = reinterpret_cast<float*>(smem4);  // KD * LDQ
  float* KV = Qt + KD * LDQ;                    // max(KD * LDK, BN * LDV)
  float* Pt = KV + max(KD * LDK, BN * LDV);     // BN * LDP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long bh = (long)blockIdx.z * p.nh_k + blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const float* qg = p.q + bh * p.QR * d;
  const uint8_t* kcg = p.kcodes + bh * p.N_max * M;
  const uint8_t* vcg = p.vcodes + bh * p.N_max * Mv;
  const __nv_bfloat16* kog = p.kout ? p.kout + bh * p.N_max * OK : nullptr;
  const __nv_bfloat16* vog = p.vout ? p.vout + bh * p.N_max * OV : nullptr;

  // query tile, k-major; rows past QR are zero. Rows d .. d + OK - 1 hold
  // the query's outlier channels.
  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, k = i - r * d;
    Qt[k * LDQ + r] = (row0 + r < p.QR) ? qg[(long)(row0 + r) * d + k] : 0.f;
  }
  for (int i = tid; i < BQ * OK; i += THREADS) {
    const int r = i / OK, o = i - r * OK;
    Qt[(d + o) * LDQ + r] = (row0 + r < p.QR) ? qg[(long)(row0 + r) * d + p.koidx[o]] : 0.f;
  }

  float acc[8][8], m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = 0; n0 < p.n_codes; n0 += BN) {
    const int nt = min(BN, p.n_codes - n0);

    // 1. K_hat of the tile: a thread takes four subspaces of one token (one
    // subspace where M % 4 != 0: fewer than four wide subspaces)
    if (M % 4) {
      for (int i = tid; i < BN * M; i += THREADS) {
        const int tok = i % BN, m = i / BN;
        const int code = tok < nt ? kcg[(long)(n0 + tok) * M + m] : 0;
        const float* cent = p.kcent + ((long)m * p.Ck + code) * p.dmk;
        for (int j = 0; j < p.dmk; ++j) KV[(m + j * M) * LDK + tok] = (tok < nt) ? __ldg(cent + j) : 0.f;
      }
    }
    for (int i = tid; i < BN * (M % 4 ? 0 : M / 4); i += THREADS) {
      const int tok = i % BN, mq = i / BN;
      uint32_t w = 0;
      if (tok < nt) w = *reinterpret_cast<const uint32_t*>(kcg + (long)(n0 + tok) * M + mq * 4);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int m = mq * 4 + k4;
        const float* cent = p.kcent + ((long)m * p.Ck + ((w >> (8 * k4)) & 0xFF)) * p.dmk;
        for (int j = 0; j < p.dmk; ++j)
          KV[(m + j * M) * LDK + tok] = (tok < nt) ? __ldg(cent + j) : 0.f;
      }
    }
    for (int i = tid; i < BN * OK; i += THREADS) {
      const int tok = i % BN, o = i / BN;
      KV[(d + o) * LDK + tok] =
          (tok < nt) ? __bfloat162float(kog[(long)(n0 + tok) * OK + o]) : 0.f;
    }
    __syncthreads();

    // 2. S = Q Kt, rows {ty*4.., 64 + ty*4..} x tokens {tx*4.., 64 + tx*4..}
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < KD; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(Qt + k * LDQ + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(Qt + k * LDQ + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(KV + k * LDK + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(KV + k * LDK + 64 + tx * 4);
      outer8(s, a0, a1, b0, b1);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int tj = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      if (tj >= nt) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][j] = -INFINITY;
      }
    }
    // online softmax; the tile holds a valid token, so the new max is finite
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float alpha = expf(m_run[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      l_run[i] = l_run[i] * alpha + ps;  // this thread's tokens; summed at the end
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int tj = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      *reinterpret_cast<float4*>(Pt + tj * LDP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(Pt + tj * LDP + 64 + ty * 4) =
          make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();  // Kt has been read by all; Pt is complete

    // 3. V_hat of the tile, token-major, over the K_hat buffer
    for (int i = tid; i < BN * Mv; i += THREADS) {
      const int tok = i / Mv, m = i - tok * Mv;
      if (tok < nt) {
        const float* cent = p.vcent + ((long)m * p.Cv + vcg[(long)(n0 + tok) * Mv + m]) * p.dmv;
        for (int j = 0; j < p.dmv; ++j) KV[tok * LDV + m + j * Mv] = __ldg(cent + j);
      } else {
        for (int j = 0; j < p.dmv; ++j) KV[tok * LDV + m + j * Mv] = 0.f;
      }
    }
    if (OV > 0) {
      __syncthreads();  // the exact channels go over the decoded ones
      for (int i = tid; i < BN * OV; i += THREADS) {
        const int tok = i / OV, o = i - tok * OV;
        KV[tok * LDV + p.voidx[o]] =
            (tok < nt) ? __bfloat162float(vog[(long)(n0 + tok) * OV + o]) : 0.f;
      }
    }
    __syncthreads();

    // 4. acc += P V_hat, rows as above x dims {tx*4.., 64 + tx*4..}
#pragma unroll 4
    for (int k = 0; k < nt; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(Pt + k * LDP + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(Pt + k * LDP + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(KV + k * LDV + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(KV + k * LDV + 64 + tx * 4);
      outer8(acc, a0, a1, b0, b1);
    }
    __syncthreads();  // the next tile rewrites KV and Pt
  }

  float* og = p.out + bh * p.QR * d;
  float* lg = p.lse + bh * p.QR;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float l = row_sum(l_run[i]);
    const int row = row0 + ((i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= p.QR) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    if (tx * 4 < d)
      *reinterpret_cast<float4*>(og + (long)row * d + tx * 4) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    if (64 + tx * 4 < d)
      *reinterpret_cast<float4*>(og + (long)row * d + 64 + tx * 4) =
          make_float4(acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv, acc[i][7] * inv);
    if (tx == 0) lg[row] = l > 0.f ? m_run[i] + logf(l) : NEG_BIG;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core version, warp-specialised for Hopper.
//
// Producer warpgroups decode tile t + 1 into shared memory while consumer
// warpgroups multiply tile t on wgmma.
// - A block owns MQ = 128 query rows of one (b, h) and walks the history in
//   tiles of NT = 64 tokens, with two consumer warpgroups of 64 rows and two
//   producer warpgroups; setmaxnreg moves registers from the producers to
//   the consumers. The grid is plain, (QR / 128, nh_k, bs): 3,072 blocks at
//   a 4096-token chunk, 576 at a 6-slot 512-token admission chunk.
// - The producers hold both codebooks in shared memory as bf16 (64 KB a side
//   at C = 256, d = 128). They stage the code and exact-channel rows of the
//   next tiles with cp.async (16 bytes a copy, rows padded against bank
//   conflicts where there is room) into a ring of 2 or 3 slots, and decode
//   each tile into a ring of 2 to 4 stages: as many as fit, by the same plan
//   in mma_plan and in the Python wrapper's mirror of it.
// - A decoded tile is written straight in the layout wgmma reads: 8 x 8 core
//   matrices of 128 bytes, no swizzle, byte (g * NT + token) * 16 for the 8
//   positions of group g. Positions are taken subspace-major (position
//   m * d_m + j holds dim m + j * M), so 8 positions are 8 / d_m whole
//   centroids: four 4-byte gathers at d_m = 2, two 8-byte ones at d_m = 4. A
//   producer thread keeps one token and a quarter of its groups, two
//   neighbouring groups at a time, so their code bytes are one vector load,
//   their gathers are independent loads (at C = 128 and 256 with the
//   subspace offsets as immediates) and the 16-byte stores of neighbouring
//   lanes fill whole core matrices. The score product sums over positions,
//   so q takes the same order; output columns are put back in dim order when
//   they are written.
// - Exact channels, when either side has them (at most 16 a side): the exact
//   K channels are positions d .. d + 15 of K_hat (zero-padded), and the
//   exact V channels 16 more columns right after V_hat's d, so one product
//   covers both; their columns replace the decoded values of those dims when
//   the output is written.
// - Each consumer keeps its 64 x (d + 16) query fragments in registers. Per
//   tile it issues one batch of wgmma: S(t) = Q K_hat(t)^T with m64n64k16
//   (A from registers, K_hat K-major) and O += P(t - 1) V_hat(t - 1) with
//   m64n{d + 16 or d}k16 (P straight from the score registers as the A
//   operand, V_hat MN-major, B transposed); then it masks the ragged tail
//   and runs the online softmax of tile t in registers while the other
//   consumer's batch runs on the tensor cores.
// - Each stage has a full and an empty mbarrier for either half: K_hat is
//   handed back once S(t) is done, V_hat once P V(t) is, so the producers
//   refill the K half of a stage while its V half is still being read.
// d = 16 (test-tiny in bf16) takes the same route (m64n16 for P V_hat). d = 64
// always takes the 16 exact positions, zero when there are no exact channels:
// with its 16 query-fragment registers the same shape as P's, ptxas (CUDA
// 12.8) gave both the same registers and never restored the query.

#define WG 128                        // threads of a warpgroup
#define NCONS 2                       // consumer warpgroups, 64 query rows each
#define NPROD 2                       // producer warpgroups
#define MQ (64 * NCONS)               // query rows per block
#define PT (WG * NPROD)               // producer threads: four per token of a tile
#define MMA_THREADS (WG * (NCONS + NPROD))
#define NT 64                         // history tokens per tile
#define MAX_STAGES 4
#define SMEM_OPTIN 232448             // shared memory a block may opt in to on sm_90
#define SMEM_HEAD 256                 // the mbarriers, then the V position -> exact channel map
#define PRODUCER_REGS 72
#define CONSUMER_REGS 184
static_assert(MQ == BQ, "both versions cut the rows into blocks of the same size");
static_assert(PT == 4 * NT, "a producer thread takes a quarter of a token's groups");
static_assert((NPROD * PRODUCER_REGS + NCONS * CONSUMER_REGS) * WG <= 65536, "register file");

// Bytes between two staged rows of rb bytes. Padded, 16-byte rows get 16
// bytes more (16-byte copies land aligned and eight neighbouring rows start
// in different banks), others 4; unpadded rows (where shared memory is too
// tight for padding) are rb rounded up to 4.
static __host__ __device__ __forceinline__ int row_stride(int rb, int pad) {
  return !pad ? (rb + 3) / 4 * 4 : rb % 16 == 0 ? rb + 16 : (rb + 3) / 4 * 4 + 4;
}

// 16 exact positions when either side has exact channels, and always at d = 64
static __host__ __device__ __forceinline__ int exact_positions(int d, int OK, int OV) {
  return (OK > 0 || OV > 0 || d == 64) ? 16 : 0;
}

struct MmaPlan {
  int stages, slots, pad;
  long bytes;
};

// Shared memory of the tensor-core version: the head, both bf16 codebooks,
// `slots` slots of one tile's staged code and exact-channel rows, and
// `stages` decoded tiles, each K_hat (d + op positions), V_hat (d) and the
// exact V channels (op), 64 tokens in bf16. The first of (three slots,
// padded rows), (two, padded), (two, unpadded) beside which two stages fit;
// then as many stages as fit, 2 to 4.
static MmaPlan mma_plan(int d, int OK, int Ck, int Cv, int M, int Mv, int OV) {
  const long op = exact_positions(d, OK, OV);
  const long stage = 2L * NT * (2 * d + 2 * op), base = SMEM_HEAD + 2L * (Ck + Cv) * d;
  const int tries[3][2] = {{3, 1}, {2, 1}, {2, 0}};
  long n = 0, slot = 0;
  int t = 0;
  for (; t < 3; ++t) {
    const int pad = tries[t][1];
    slot = (long)NT * (row_stride(M, pad) + row_stride(Mv, pad) + (OK > 0 ? row_stride(2 * OK, pad) : 0) +
                       (OV > 0 ? row_stride(2 * OV, pad) : 0));
    n = (SMEM_OPTIN - base - tries[t][0] * slot) / stage;
    if (n >= 2 || t == 2) break;
  }
  n = n < 2 ? 2 : (n > MAX_STAGES ? MAX_STAGES : n);
  return {(int)n, tries[t][0], tries[t][1], base + tries[t][0] * slot + n * stage};
}

// Copy `rows` rows of rb bytes (rb % 4 == 0, contiguous in device memory) to
// shared rows of stride rs, asynchronously, with the PT producer threads: 16
// bytes a copy where the rows allow it, else 4.
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* src, int rows, int rb, int rs,
                                          int lt) {
  const bool wide = rb % 16 == 0 && rs % 16 == 0;
  const int w = wide ? 16 : 4, per = rb / w, dr = PT / per, dc = PT - dr * per;
  int r = lt / per, c = lt - r * per;
  while (r < rows) {
    const unsigned d = smem_u32(dst + r * rs + c * w);
    const uint8_t* g = src + (long)r * rb + c * w;
    if (wide)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(g));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(g));
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// Positions 8 g .. 8 g + 7 of one decoded row: position p holds component
// p % dm of the centroid of subspace p / dm. cb: the side's bf16 codebooks
// (subspaces, C, dm); crow: the token's code row.
__device__ __forceinline__ uint4 decode8(const uint16_t* cb, int C, int dm, const uint8_t* crow, int g) {
  uint4 r;
  if (dm == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(crow + g * 4);
    const uint32_t* c = reinterpret_cast<const uint32_t*>(cb) + g * 4 * C;
    r.x = c[w & 0xFF];
    r.y = c[C + ((w >> 8) & 0xFF)];
    r.z = c[2 * C + ((w >> 16) & 0xFF)];
    r.w = c[3 * C + (w >> 24)];
  } else if (dm == 4) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(crow + g * 2);
    const uint2* c = reinterpret_cast<const uint2*>(cb) + g * 2 * C;
    const uint2 a = c[w & 0xFF], b = c[C + (w >> 8)];
    r = make_uint4(a.x, a.y, b.x, b.y);
  } else if (dm == 1) {
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(crow + g * 8);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(crow + g * 8 + 4);
    const uint16_t* c = cb + g * 8 * C;
    r.x = c[w0 & 0xFF] | ((uint32_t)c[C + ((w0 >> 8) & 0xFF)] << 16);
    r.y = c[2 * C + ((w0 >> 16) & 0xFF)] | ((uint32_t)c[3 * C + (w0 >> 24)] << 16);
    r.z = c[4 * C + (w1 & 0xFF)] | ((uint32_t)c[5 * C + ((w1 >> 8) & 0xFF)] << 16);
    r.w = c[6 * C + ((w1 >> 16) & 0xFF)] | ((uint32_t)c[7 * C + (w1 >> 24)] << 16);
  } else {  // dm >= 8: one centroid covers dm / 8 groups
    const int m = g * 8 / dm;
    r = *reinterpret_cast<const uint4*>(cb + (m * C + crow[m]) * dm + (g * 8) % dm);
  }
  return r;
}

// NB bytes (2, 4, 8 or 16) from an NB-aligned shared address, as 32-bit words
template <int NB>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint32_t (&w)[(NB + 3) / 4]) {
  if constexpr (NB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

template <int NB>
__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[NB], int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFF;
}

// One thread's part of a decoded row of DG groups: four threads share a
// token, thread gq takes GPT neighbouring groups from gq * GPT, two at a time
// (their gathers are independent loads), and writes them at
// dst[g * NT + tok] (zero for a token past n_codes). crow: the token's staged
// codes; cb: the side's bf16 codebooks (subspaces, C, dm).
template <int DG, int CT>
__device__ __forceinline__ void decode_row_c(uint4* dst, const uint16_t* cb, int C_rt, int dm, const uint8_t* crow,
                                             int tok, int gq, bool live) {
  constexpr int GPT = DG >= 4 ? DG / 4 : 1, R = GPT >= 2 ? 2 : 1;
  const int C = CT > 0 ? CT : C_rt;  // a compile-time C turns subspace offsets into immediates
  const int g0 = gq * GPT;
  if (g0 >= DG) return;
#pragma unroll
  for (int j0 = 0; j0 < GPT; j0 += R) {
    const int g = g0 + j0;
    uint4 v[R];
    if (dm == 2) {  // a group is four codes, each a 4-byte centroid
      uint32_t w[R];
      load_bytes<4 * R>(crow + 4 * g, w);
      const uint32_t* c = reinterpret_cast<const uint32_t*>(cb) + 4 * g * C;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const uint32_t* cj = c + 4 * j * C;
        v[j] = make_uint4(cj[byte_at(w, 4 * j)], cj[C + byte_at(w, 4 * j + 1)],
                          cj[2 * C + byte_at(w, 4 * j + 2)], cj[3 * C + byte_at(w, 4 * j + 3)]);
      }
    } else if (dm == 4) {  // two codes, each an 8-byte centroid
      uint32_t w[(2 * R + 3) / 4];
      load_bytes<2 * R>(crow + 2 * g, w);
      const uint2* c = reinterpret_cast<const uint2*>(cb) + 2 * g * C;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const uint2 a = c[2 * j * C + byte_at(w, 2 * j)], b = c[(2 * j + 1) * C + byte_at(w, 2 * j + 1)];
        v[j] = make_uint4(a.x, a.y, b.x, b.y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = decode8(cb, C, dm, crow, g + j);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) dst[(g + j) * NT + tok] = live ? v[j] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// decode_row_c for the side's codebook size: 256 and 128 compiled apart
template <int DG>
__device__ __forceinline__ void decode_row(uint4* dst, const uint16_t* cb, int C, int dm, const uint8_t* crow,
                                           int tok, int gq, bool live) {
  if (C == 256) decode_row_c<DG, 256>(dst, cb, C, dm, crow, tok, gq, live);
  else if (C == 128) decode_row_c<DG, 128>(dst, cb, C, dm, crow, tok, gq, live);
  else decode_row_c<DG, 0>(dst, cb, C, dm, crow, tok, gq, live);
}

// Exact channels o0 .. o0 + 7 of a staged bf16 row of O channels, zero past O.
__device__ __forceinline__ uint4 exact8(const uint8_t* row, int o0, int O) {
  if (o0 >= O) return make_uint4(0u, 0u, 0u, 0u);
  if (O % 8 == 0) return *reinterpret_cast<const uint4*>(row + o0 * 2);
  const uint16_t* h = reinterpret_cast<const uint16_t*>(row);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int o = o0 + 2 * e;
    w[e] = (o < O ? h[o] : 0u) | ((o + 1 < O ? (uint32_t)h[o + 1] : 0u) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// D = head dim; OP = 16 exact positions (exact_positions) or 0
template <int D, int OP>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    pq_chunk_attention_mma_kernel(ChunkParams p, int stages, int nslots, int pad) {
  constexpr int KS = (D + OP) / 16;         // k-steps of the score product
  constexpr int DG = D / 8, OG = OP / 8;    // 8-position groups of a decoded row and of exact channels
  // a stage: K_hat (D + OP positions: the decoded dims, then the exact K
  // channels), V_hat (D), the exact V channels (OP); NT tokens each
  constexpr int KT = NT * (D + OP) * 2, VT = NT * D * 2, STAGE = KT + VT + NT * OP * 2;
  extern __shared__ __align__(128) uint8_t smem[];
  // a full and an empty mbarrier per stage for either half: K_hat (with the
  // exact K channels), and V_hat (with the exact V channels)
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full_v = full_k + MAX_STAGES;
  uint64_t* empty_k = full_v + MAX_STAGES;
  uint64_t* empty_v = empty_k + MAX_STAGES;
  int8_t* vmap = reinterpret_cast<int8_t*>(smem + 8 * 4 * MAX_STAGES);  // V position -> exact channel or -1
  uint16_t* kcs = reinterpret_cast<uint16_t*>(smem + SMEM_HEAD);        // (M, Ck, dmk) bf16
  uint16_t* vcs = kcs + p.Ck * D;                                        // (Mv, Cv, dmv) bf16
  uint8_t* tiles = reinterpret_cast<uint8_t*>(vcs + p.Cv * D);           // `stages` stages
  const int M = p.M, Mv = p.Mv, OK = p.OK, OV = p.OV, dmk = p.dmk, dmv = p.dmv;
  // a slot: the staged K code, V code, exact K and exact V rows of a tile
  const int sk = row_stride(M, pad), sv = row_stride(Mv, pad), sko = OK > 0 ? row_stride(2 * OK, pad) : 0,
            svo = OV > 0 ? row_stride(2 * OV, pad) : 0;
  const int slot_bytes = NT * (sk + sv + sko + svo);
  uint8_t* slots = tiles + stages * STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long bh = (long)blockIdx.z * p.nh_k + blockIdx.y;
  const int n_tiles = (p.n_codes + NT - 1) / NT;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_k + s, PT);            // the producers' threads, once a half is decoded
      mbar_init(full_v + s, PT);
      mbar_init(empty_k + s, NCONS * WG);   // the consumers' threads, once its product is done
      mbar_init(empty_v + s, NCONS * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < D; i += MMA_THREADS) {
    int o = -1;
    for (int j = 0; j < OV; ++j) {
      const int c = p.voidx[j];
      if ((c % Mv) * dmv + c / Mv == i) o = j;
    }
    vmap[i] = (int8_t)o;
  }
  for (int i = tid; i < p.Ck * D; i += MMA_THREADS) kcs[i] = bf16_bits(p.kcent[i]);
  for (int i = tid; i < p.Cv * D; i += MMA_THREADS) vcs[i] = bf16_bits(p.vcent[i]);
  __syncthreads();

  if (warp >= NCONS * 4) {
    // ---- producers: stage the rows of later tiles, decode tile t ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lt = tid - NCONS * WG, tok = lt % NT, gq = lt / NT;
    // the rows' device addresses are rebuilt from the parameters per tile
    // rather than held in registers across the loop
    auto stage_rows = [&](int tile) {
      const long n0 = (long)tile * NT, row0 = bh * p.N_max + n0;
      const int nt = min(NT, p.n_codes - tile * NT);
      uint8_t* b = slots + (tile % nslots) * slot_bytes;
      copy_rows(b, p.kcodes + row0 * M, nt, M, sk, lt);
      copy_rows(b + NT * sk, p.vcodes + row0 * Mv, nt, Mv, sv, lt);
      if (OK > 0)
        copy_rows(b + NT * (sk + sv), reinterpret_cast<const uint8_t*>(p.kout + row0 * OK), nt, 2 * OK, sko, lt);
      if (OV > 0)
        copy_rows(b + NT * (sk + sv + sko), reinterpret_cast<const uint8_t*>(p.vout + row0 * OV), nt, 2 * OV,
                  svo, lt);
    };
    // one cp.async group per tile, empty past the last, so that "all but the
    // newest nslots - 2 groups" is the tile to decode
    for (int tile = 0; tile < nslots - 1; ++tile) {
      if (tile < n_tiles) stage_rows(tile);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int it = 0; it < n_tiles; ++it) {
      if (nslots == 3)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      // every producer thread's rows of tile it have landed, and tile it - 1
      // is decoded, so its slot may take the rows of tile it + nslots - 1
      asm volatile("bar.sync 1, %0;\n" ::"n"(PT) : "memory");
      if (it + nslots - 1 < n_tiles) stage_rows(it + nslots - 1);
      asm volatile("cp.async.commit_group;\n" ::);
      const int s = it % stages;
      const uint32_t free_parity = ((it / stages) & 1) ^ 1;  // the first pass finds every stage free
      const bool live = tok < p.n_codes - it * NT;
      const uint8_t* b = slots + (it % nslots) * slot_bytes;
      uint4* kt = reinterpret_cast<uint4*>(tiles + s * STAGE);
      // K_hat, then the exact K channels (two groups, on two of a token's threads)
      mbar_wait(empty_k + s, free_parity);
      decode_row<DG>(kt, kcs, p.Ck, dmk, b + tok * sk, tok, gq, live);
      if constexpr (OP > 0) {
        if (gq < 2) kt[(DG + gq) * NT + tok] = live ? exact8(b + NT * (sk + sv) + tok * sko, gq * 8, OK)
                                                    : make_uint4(0u, 0u, 0u, 0u);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      mbar_arrive(full_k + s);
      // V_hat, then the exact V channels
      mbar_wait(empty_v + s, free_parity);
      decode_row<DG>(kt + NT * (DG + OG), vcs, p.Cv, dmv, b + NT * sk + tok * sv, tok, gq, live);
      if constexpr (OP > 0) {
        if (gq >= 2)
          kt[(2 * DG + OG + gq - 2) * NT + tok] = live ? exact8(b + NT * (sk + sv + sko) + tok * svo, (gq - 2) * 8, OV)
                                                       : make_uint4(0u, 0u, 0u, 0u);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full_v + s);
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int g = lane >> 2, t = lane & 3;
    const int row_a = blockIdx.x * MQ + (warp >> 2) * 64 + (warp & 3) * 16 + g, row_b = row_a + 8;
    const float* qg = p.q + bh * p.QR * D;
    // query fragments in K_hat's position order: position k < D is dim
    // (k % dmk) * M + k / dmk, then q[koidx[k - D]], then 0
    auto qx = [&](int row, int k) -> float {
      if (row >= p.QR) return 0.f;
      if (k < D) return qg[(long)row * D + (k % dmk) * M + k / dmk];
      return (k - D < OK) ? qg[(long)row * D + p.koidx[k - D]] : 0.f;
    };
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k0 = ks * 16 + t * 2;
      qa[ks][0] = pack_bf16(qx(row_a, k0), qx(row_a, k0 + 1));
      qa[ks][1] = pack_bf16(qx(row_b, k0), qx(row_b, k0 + 1));
      qa[ks][2] = pack_bf16(qx(row_a, k0 + 8), qx(row_a, k0 + 9));
      qa[ks][3] = pack_bf16(qx(row_b, k0 + 8), qx(row_b, k0 + 9));
    }
    // oacc: P times V_hat's D positions, then the OP exact V channels, which
    // follow V_hat in a stage so that one product covers both
    float oacc[(D + OP) / 2], sacc[NT / 2];
#pragma unroll
    for (int i = 0; i < (D + OP) / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) sacc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    const float L2E = 1.4426950408889634f;

    uint32_t pa[NT / 16][4];  // P of the previous tile as the A operand: tokens 16 kk .. 16 kk + 15

    // Iteration it issues S(it) = Q K_hat(it)^T and O += P(it - 1) V_hat(it - 1)
    // as one batch, then runs the softmax of tile it while the other consumer
    // warpgroup's batch runs; each half of a stage is handed back as soon as
    // its product is done.
    for (int it = 0; it <= n_tiles; ++it) {
      const bool has_s = it < n_tiles, has_pv = it > 0;
      if (!has_s && !has_pv) break;
      const int s = it % stages, sp = (it + stages - 1) % stages;
      if (has_s) mbar_wait(full_k + s, (it / stages) & 1);
      if (has_pv) mbar_wait(full_v + sp, ((it - 1) / stages) & 1);
      // K_hat: K-major, core matrices NT * 16 bytes apart along K, 128 along N;
      // V_hat and the exact V channels: MN-major, 128 bytes apart along K
      // (tokens), NT * 16 along N
      const uint8_t* kt = tiles + s * STAGE;
      const uint8_t* vt = tiles + sp * STAGE + KT;
      const uint64_t dk = smem_desc(kt, NT * 16, 128), dv = smem_desc(vt, 128, NT * 16);
      reg_fence(sacc);
      reg_fence(oacc);
      wgmma_fence();
      if (has_s) {
        // S: register sacc[4 i + 2 h + j] holds row (h ? row_b : row_a), token 8 i + 2 t + j
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) wgmma_s64(sacc, qa[ks], dk + (uint64_t)((ks * 2 * NT * 16) >> 4), ks > 0);
      }
      if (has_pv) {
#pragma unroll
        for (int kk = 0; kk < NT / 16; ++kk) wgmma_pv<D + OP>(oacc, pa[kk], dv + (uint64_t)((kk * 2 * 128) >> 4));
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(sacc);
      reg_fence(oacc);
      if (has_s) mbar_arrive(empty_k + s);
      if (has_pv) mbar_arrive(empty_v + sp);
      if (!has_s) break;

      // mask the ragged tail; online softmax over rows row_a and row_b
      const int nt = min(NT, p.n_codes - it * NT);
      if (nt < NT) {
#pragma unroll
        for (int i = 0; i < NT / 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (i * 8 + t * 2 + j >= nt) sacc[4 * i + j] = sacc[4 * i + 2 + j] = -INFINITY;
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < NT / 8; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);  // finite: the tile has a token
      const float al_a = ex2((m_a - mn_a) * L2E), al_b = ex2((m_b - mn_b) * L2E);
      const float sa = mn_a * L2E, sb = mn_b * L2E;
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int i = 0; i < NT / 8; ++i) {
        sacc[4 * i] = ex2(fmaf(sacc[4 * i], L2E, -sa));
        sacc[4 * i + 1] = ex2(fmaf(sacc[4 * i + 1], L2E, -sa));
        sacc[4 * i + 2] = ex2(fmaf(sacc[4 * i + 2], L2E, -sb));
        sacc[4 * i + 3] = ex2(fmaf(sacc[4 * i + 3], L2E, -sb));
        ps_a += sacc[4 * i] + sacc[4 * i + 1];
        ps_b += sacc[4 * i + 2] + sacc[4 * i + 3];
      }
      l_a = l_a * al_a + ps_a;  // this lane's tokens; summed over the row's lanes at the end
      l_b = l_b * al_b + ps_b;
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      // rescale the sums (which now hold P(it - 1) V_hat(it - 1)) when the
      // running max moved for a row of this warp; over a long history it
      // soon stops moving, and alpha is then exactly 1
      if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
        for (int i = 0; i < (D + OP) / 8; ++i) {
          oacc[4 * i] *= al_a;
          oacc[4 * i + 1] *= al_a;
          oacc[4 * i + 2] *= al_b;
          oacc[4 * i + 3] *= al_b;
        }
      }
    }

#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
    }
    float* og = p.out + bh * p.QR * D;
    float* lg = p.lse + bh * p.QR;
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f, inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    // column k < D of oacc is V_hat's position k, dim (k % dmv) * Mv + k / dmv,
    // unless that dim is an exact channel; column D + o is exact channel o
#pragma unroll
    for (int i = 0; i < (D + OP) / 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = i * 8 + t * 2 + j;
        int c;
        if (k < D) {
          if (OP > 0 && vmap[k] >= 0) continue;
          c = (k % dmv) * Mv + k / dmv;
        } else {
          if (k - D >= OV) continue;
          c = p.voidx[k - D];
        }
        if (row_a < p.QR) og[(long)row_a * D + c] = oacc[4 * i + j] * inv_a;
        if (row_b < p.QR) og[(long)row_b * D + c] = oacc[4 * i + 2 + j] * inv_b;
      }
    }
    if (t == 0) {
      if (row_a < p.QR) lg[row_a] = l_a > 0.f ? m_a + logf(l_a) : NEG_BIG;
      if (row_b < p.QR) lg[row_b] = l_b > 0.f ? m_b + logf(l_b) : NEG_BIG;
    }
  }
}

extern "C" int pq_chunk_attention_q_block() { return BQ; }

// Shared memory one block needs, in bytes (the wrapper checks it against the
// card's limit before a launch). bf16_mma selects the tensor-core version.
extern "C" long pq_chunk_attention_smem(int d, int OK, int Ck, int Cv, int bf16_mma, int M, int Mv,
                                        int OV) {
  if (bf16_mma) return mma_plan(d, OK, Ck, Cv, M, Mv, OV).bytes;
  const long KD = d + OK;
  const long kv = KD * LDK > BN * LDV ? KD * LDK : BN * LDV;
  return 4 * (KD * LDQ + kv + (long)BN * LDP);
}

// the tensor-core version's decoded-tile stages and staging slots
extern "C" int pq_chunk_attention_stages(int d, int OK, int Ck, int Cv, int M, int Mv, int OV) {
  return mma_plan(d, OK, Ck, Cv, M, Mv, OV).stages;
}

extern "C" int pq_chunk_attention_slots(int d, int OK, int Ck, int Cv, int M, int Mv, int OV) {
  return mma_plan(d, OK, Ck, Cv, M, Mv, OV).slots;
}

static cudaError_t set_smem(const void* kernel, long smem, long& attr_set) {
  if (smem <= attr_set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) attr_set = smem;
  return e;
}

template <int D, int OP>
static cudaError_t launch_mma(const ChunkParams& p, int bs, cudaStream_t st) {
  static long attr_set = 0;
  const MmaPlan plan = mma_plan(p.d, p.OK, p.Ck, p.Cv, p.M, p.Mv, p.OV);
  auto kernel = pq_chunk_attention_mma_kernel<D, OP>;
  cudaError_t e = set_smem((const void*)kernel, plan.bytes, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((p.QR + MQ - 1) / MQ), (unsigned)p.nh_k, (unsigned)bs);
  kernel<<<grid, MMA_THREADS, plan.bytes, st>>>(p, plan.stages, plan.slots, plan.pad);
  return cudaGetLastError();
}

// Launches the kernel on `stream`: grid (ceil(QR / 128), nh_k, bs). bf16_mma
// selects the tensor-core version, built for d in {16, 64, 128} and up to 16
// exact channels a side. Returns a cudaError_t (0 on success); the caller
// validates shapes and types.
extern "C" int pq_chunk_attention(
    const void* q, const void* kcodes, const void* vcodes, const void* kcent, const void* vcent,
    const void* kout, const void* vout, const void* koidx, const void* voidx,
    void* out, void* lse,
    int bs, int nh_k, int QR, int d, int M, int Ck, int Mv, int Cv, int OK, int OV,
    int N_max, int n_codes, int bf16_mma, void* stream) {
  ChunkParams p;
  p.q = (const float*)q;
  p.kcodes = (const uint8_t*)kcodes;
  p.vcodes = (const uint8_t*)vcodes;
  p.kcent = (const float*)kcent;
  p.vcent = (const float*)vcent;
  p.kout = (const __nv_bfloat16*)kout;
  p.vout = (const __nv_bfloat16*)vout;
  p.koidx = (const int*)koidx;
  p.voidx = (const int*)voidx;
  p.out = (float*)out;
  p.lse = (float*)lse;
  p.nh_k = nh_k; p.QR = QR; p.d = d; p.M = M; p.Ck = Ck; p.dmk = d / M;
  p.Mv = Mv; p.Cv = Cv; p.dmv = d / Mv; p.OK = OK; p.OV = OV;
  p.N_max = N_max; p.n_codes = n_codes;
  cudaStream_t st = (cudaStream_t)stream;
  if (!bf16_mma) {
    static long attr_set = 0;
    const long smem = pq_chunk_attention_smem(d, OK, Ck, Cv, 0, M, Mv, OV);
    cudaError_t e = set_smem((const void*)pq_chunk_attention_kernel, smem, attr_set);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((QR + BQ - 1) / BQ), (unsigned)nh_k, (unsigned)bs);
    pq_chunk_attention_kernel<<<grid, THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  const bool op = exact_positions(d, OK, OV) > 0;
  if (d == 128) return (int)(op ? launch_mma<128, 16>(p, bs, st) : launch_mma<128, 0>(p, bs, st));
  if (d == 64) return (int)launch_mma<64, 16>(p, bs, st);
  if (d == 16) return (int)(op ? launch_mma<16, 16>(p, bs, st) : launch_mma<16, 0>(p, bs, st));
  return (int)cudaErrorInvalidValue;
}
