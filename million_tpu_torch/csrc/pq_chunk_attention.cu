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
// Design. Blocks run in no order, so the TPU kernel's history axis of the
// grid becomes a loop: a block owns BQ = 128 query rows of one (b, h) and
// walks the history in tiles of BN = 128 tokens, carrying the online-softmax
// state (row max, row sum, the 128 x d accumulator) in registers. Rows are
// plentiful (12,288 per (b, h) at a 4096-token chunk with G = 3), so the
// history is not split and there is no reduce pass. Per tile:
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
//
// Bound. 2 x rows x n_codes x (2 d + OK) operations: 6.1 TFLOP at bs = 4, 8
// KV heads, 12,288 rows, 28,672 history tokens, d = 128, OK = 16, which is
// 6.2 ms at the 989 TFLOP/s bf16 tensor-core peak (the card's bound for this
// product) and 92 ms at the 67 TFLOP/s f32 rate this kernel is built on. The
// bytes (q, out, codes) are 0.5 GB, 0.15 ms. The tensor-core version further
// down (q, K_hat, V_hat and P rounded to bf16) is the way from the f32
// ceiling towards that bound; 16-bit models take it, f32 models this one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

    // 1. K_hat of the tile: a thread takes four subspaces of one token
    for (int i = tid; i < BN * (M / 4); i += THREADS) {
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
// The tensor-core version, for 16-bit models: the same function with q, K_hat,
// V_hat and P rounded to bf16 and f32 accumulation (mma.sync m16n8k16), which
// is how the model's own attention products run on the card. It is what
// takes the kernel from the f32 ceiling towards the tensor-core bound.
//
// A block is 8 warps of 16 query rows and walks the history in tiles of
// MN = 64 tokens. Rounded to bf16 both codebooks fit in shared memory (64 KB
// a side at C = 256, d = 128), so the decode gathers from shared memory. Each
// warp keeps its 16 x (d + OK) query fragments, the 16 x 64 scores and the
// 16 x d accumulator in registers; the scores become the A fragments of the
// P V product without leaving the registers. The decode writes the layouts
// the B fragments want, so a fragment register is one 32-bit shared-memory
// read: Ks[token][dim] (pairs of neighbouring dims) and Vt[dim][token]
// (pairs of neighbouring tokens), rows padded by 16 bytes against bank
// conflicts. The exact K outlier rows are extra dims of Ks, zero-padded to a
// multiple of 16; the exact V outlier channels overwrite rows of Vt. The code
// and outlier rows of the next tile are copied into a second staging buffer
// with cp.async while the current tile is decoded and multiplied, so no
// device-memory latency sits between two tiles.

#define MQ 128   // query rows per block: 8 warps x 16
#define MN 64    // history tokens per tile
#define LDVT (MN + 8)

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src));
}

// Copy `rows` rows of rb bytes (rb % 4 == 0, contiguous in device memory) to
// shared rows of stride rs, asynchronously.
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src, int rows, int rb, int rs) {
  const int per = rb / 4;
  for (int i = threadIdx.x; i < rows * per; i += THREADS) {
    const int r = i / per, c = i - r * per;
    cp_async4(dst + r * rs + c * 4, src + (long)r * rb + c * 4);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = head dim, OKP = K outlier channels padded to a multiple of 16
template <int D, int OKP>
__global__ void __launch_bounds__(THREADS, 1) pq_chunk_attention_mma_kernel(ChunkParams p) {
  constexpr int KDP = D + OKP;   // contraction length of the score product
  constexpr int KS = KDP / 16;   // its k-steps
  constexpr int DN = D / 8;      // n-tiles of the output
  constexpr int LDKS = KDP + 8;
  extern __shared__ float4 smem4[];
  const int M = p.M, Mv = p.Mv, OK = p.OK, OV = p.OV;
  unsigned short* kcs = reinterpret_cast<unsigned short*>(smem4);  // Ck * D
  unsigned short* vcs = kcs + p.Ck * D;                            // Cv * D
  unsigned short* Ks = vcs + p.Cv * D;                             // MN * LDKS
  unsigned short* Vt = Ks + MN * LDKS;                             // D * LDVT
  // two staging buffers of one tile's rows: K codes and V codes (rows padded
  // by 4 bytes against bank conflicts), K and V outlier channels
  uint8_t* stg = reinterpret_cast<uint8_t*>(Vt + D * LDVT);
  const int sk = M + 4, sv = Mv + 4, sko = 2 * OK, svo = 2 * OV;
  const int stage_bytes = MN * (sk + sv + sko + svo);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long bh = (long)blockIdx.z * p.nh_k + blockIdx.y;
  const int row_a = blockIdx.x * MQ + warp * 16 + g, row_b = row_a + 8;
  const float* qg = p.q + bh * p.QR * D;
  const uint8_t* kcg = p.kcodes + bh * p.N_max * M;
  const uint8_t* vcg = p.vcodes + bh * p.N_max * Mv;
  const __nv_bfloat16* kog = p.kout ? p.kout + bh * p.N_max * OK : nullptr;
  const __nv_bfloat16* vog = p.vout ? p.vout + bh * p.N_max * OV : nullptr;

  for (int i = tid; i < p.Ck * D; i += THREADS) kcs[i] = bf16_bits(p.kcent[i]);
  for (int i = tid; i < p.Cv * D; i += THREADS) vcs[i] = bf16_bits(p.vcent[i]);
  for (int i = tid; i < MN * LDKS; i += THREADS) Ks[i] = 0;  // the padded dims stay 0

  // query fragments: element (row, k) is q[row][k], then q[row][koidx[k - D]], then 0
  auto qx = [&](int row, int k) -> float {
    if (row >= p.QR) return 0.f;
    if (k < D) return qg[(long)row * D + k];
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

  float oacc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[dn][j] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  __syncthreads();

  const int dmk = p.dmk, dmv = p.dmv, mq_n = M / 4, mvq_n = Mv / 4;
  auto stage = [&](int buf, int n0) {
    const int nt = min(MN, p.n_codes - n0);
    uint8_t* b = stg + buf * stage_bytes;
    stage_rows(b, kcg + (long)n0 * M, nt, M, sk);
    stage_rows(b + MN * sk, vcg + (long)n0 * Mv, nt, Mv, sv);
    if (OK > 0) stage_rows(b + MN * (sk + sv), reinterpret_cast<const uint8_t*>(kog + (long)n0 * OK), nt, sko, sko);
    if (OV > 0)
      stage_rows(b + MN * (sk + sv + sko), reinterpret_cast<const uint8_t*>(vog + (long)n0 * OV), nt, svo, svo);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (p.n_codes > 0) stage(0, 0);
  int buf = 0;
  for (int n0 = 0; n0 < p.n_codes; n0 += MN, buf ^= 1) {
    const int nt = min(MN, p.n_codes - n0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // this tile's rows have landed; the last tile's products are done
    if (n0 + MN < p.n_codes) stage(buf ^ 1, n0 + MN);
    const uint8_t* kst = stg + buf * stage_bytes;
    const uint8_t* vst = kst + MN * sk;
    const unsigned short* kost = reinterpret_cast<const unsigned short*>(vst + MN * sv);
    const unsigned short* vost = kost + MN * OK;

    // K_hat: an item is four neighbouring subspaces of one token
    for (int i = tid; i < MN * mq_n; i += THREADS) {
      const int tok = i / mq_n, mq = i - tok * mq_n;
      uint32_t w = 0;
      if (tok < nt) w = *reinterpret_cast<const uint32_t*>(kst + tok * sk + mq * 4);
      const unsigned short* c0 = kcs + ((mq * 4 + 0) * p.Ck + (w & 0xFF)) * dmk;
      const unsigned short* c1 = kcs + ((mq * 4 + 1) * p.Ck + ((w >> 8) & 0xFF)) * dmk;
      const unsigned short* c2 = kcs + ((mq * 4 + 2) * p.Ck + ((w >> 16) & 0xFF)) * dmk;
      const unsigned short* c3 = kcs + ((mq * 4 + 3) * p.Ck + (w >> 24)) * dmk;
      unsigned short* dst = Ks + tok * LDKS + mq * 4;
      if (tok >= nt) {
        for (int j = 0; j < dmk; ++j) *reinterpret_cast<uint2*>(dst + j * M) = make_uint2(0u, 0u);
      } else if ((dmk & 1) == 0) {  // two dims of a centroid per 32-bit read
        for (int j = 0; j < dmk; j += 2) {
          const uint32_t g0 = *reinterpret_cast<const uint32_t*>(c0 + j);
          const uint32_t g1 = *reinterpret_cast<const uint32_t*>(c1 + j);
          const uint32_t g2 = *reinterpret_cast<const uint32_t*>(c2 + j);
          const uint32_t g3 = *reinterpret_cast<const uint32_t*>(c3 + j);
          *reinterpret_cast<uint2*>(dst + j * M) =
              make_uint2(__byte_perm(g0, g1, 0x5410), __byte_perm(g2, g3, 0x5410));
          *reinterpret_cast<uint2*>(dst + (j + 1) * M) =
              make_uint2(__byte_perm(g0, g1, 0x7632), __byte_perm(g2, g3, 0x7632));
        }
      } else {
        for (int j = 0; j < dmk; ++j)
          *reinterpret_cast<uint2*>(dst + j * M) = make_uint2(
              (uint32_t)c0[j] | ((uint32_t)c1[j] << 16), (uint32_t)c2[j] | ((uint32_t)c3[j] << 16));
      }
    }
    for (int i = tid; i < MN * OK; i += THREADS) {
      const int tok = i / OK;
      Ks[tok * LDKS + D + (i - tok * OK)] = (tok < nt) ? kost[i] : (unsigned short)0;
    }
    // V_hat, dim-major: a warp takes four neighbouring subspaces, a lane two
    // neighbouring tokens
    for (int mq = warp; mq < mvq_n; mq += THREADS / 32) {
      const int t0 = lane * 2;
      const uint32_t wa = t0 < nt ? *reinterpret_cast<const uint32_t*>(vst + t0 * sv + mq * 4) : 0u;
      const uint32_t wb = t0 + 1 < nt ? *reinterpret_cast<const uint32_t*>(vst + (t0 + 1) * sv + mq * 4) : 0u;
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int m = mq * 4 + k4;
        const unsigned short* ca = vcs + (m * p.Cv + ((wa >> (8 * k4)) & 0xFF)) * dmv;
        const unsigned short* cb = vcs + (m * p.Cv + ((wb >> (8 * k4)) & 0xFF)) * dmv;
        unsigned short* dst = Vt + m * LDVT + t0;
        if ((dmv & 1) == 0) {  // two dims of a centroid per 32-bit read
          for (int j = 0; j < dmv; j += 2) {
            const uint32_t ga = t0 < nt ? *reinterpret_cast<const uint32_t*>(ca + j) : 0u;
            const uint32_t gb = t0 + 1 < nt ? *reinterpret_cast<const uint32_t*>(cb + j) : 0u;
            *reinterpret_cast<uint32_t*>(dst + j * Mv * LDVT) = __byte_perm(ga, gb, 0x5410);
            *reinterpret_cast<uint32_t*>(dst + (j + 1) * Mv * LDVT) = __byte_perm(ga, gb, 0x7632);
          }
        } else {
          for (int j = 0; j < dmv; ++j) {
            const uint32_t lo = t0 < nt ? ca[j] : 0u, hi = t0 + 1 < nt ? cb[j] : 0u;
            *reinterpret_cast<uint32_t*>(dst + j * Mv * LDVT) = lo | (hi << 16);
          }
        }
      }
    }
    if (OV > 0) {
      __syncthreads();  // the exact channels go over the decoded ones
      for (int i = tid; i < MN * OV; i += THREADS) {
        const int o = i / MN, tok = i - o * MN;  // a warp writes along one row of Vt
        Vt[p.voidx[o] * LDVT + tok] = (tok < nt) ? vost[tok * OV + o] : (unsigned short)0;
      }
    }
    __syncthreads();

    // S = Q K_hat^T: 16 rows x 64 tokens per warp
    float sacc[MN / 8][4];
#pragma unroll
    for (int nn = 0; nn < MN / 8; ++nn)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[nn][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nn = 0; nn < MN / 8; ++nn) {
        const unsigned short* kp = Ks + (nn * 8 + g) * LDKS + ks * 16 + t * 2;
        mma_bf16(sacc[nn], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    // mask the ragged tail; online softmax over rows row_a (c0, c1) and row_b (c2, c3)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nn = 0; nn < MN / 8; ++nn) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (nn * 8 + t * 2 + j >= nt) sacc[nn][j] = sacc[nn][2 + j] = -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(sacc[nn][0], sacc[nn][1]));
      mx_b = fmaxf(mx_b, fmaxf(sacc[nn][2], sacc[nn][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);  // finite: the tile has a token
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nn = 0; nn < MN / 8; ++nn) {
      sacc[nn][0] = expf(sacc[nn][0] - mn_a);
      sacc[nn][1] = expf(sacc[nn][1] - mn_a);
      sacc[nn][2] = expf(sacc[nn][2] - mn_b);
      sacc[nn][3] = expf(sacc[nn][3] - mn_b);
      ps_a += sacc[nn][0] + sacc[nn][1];
      ps_b += sacc[nn][2] + sacc[nn][3];
    }
    l_a = l_a * al_a + ps_a;  // this lane's tokens; summed over the row's lanes at the end
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      oacc[dn][0] *= al_a;
      oacc[dn][1] *= al_a;
      oacc[dn][2] *= al_b;
      oacc[dn][3] *= al_b;
    }
    // acc += P V_hat, P straight from the score registers
#pragma unroll
    for (int kk = 0; kk < MN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                              pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                              pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const unsigned short* vp = Vt + (dn * 8 + g) * LDVT + kk * 16 + t * 2;
        mma_bf16(oacc[dn], pa, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
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
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + t * 2;
    if (row_a < p.QR)
      *reinterpret_cast<float2*>(og + (long)row_a * D + col) =
          make_float2(oacc[dn][0] * inv_a, oacc[dn][1] * inv_a);
    if (row_b < p.QR)
      *reinterpret_cast<float2*>(og + (long)row_b * D + col) =
          make_float2(oacc[dn][2] * inv_b, oacc[dn][3] * inv_b);
  }
  if (t == 0) {
    if (row_a < p.QR) lg[row_a] = l_a > 0.f ? m_a + logf(l_a) : NEG_BIG;
    if (row_b < p.QR) lg[row_b] = l_b > 0.f ? m_b + logf(l_b) : NEG_BIG;
  }
}

extern "C" int pq_chunk_attention_q_block() { return BQ; }

// Shared memory one block needs, in bytes (the wrapper checks it against the
// card's limit before a launch). bf16_mma selects the tensor-core version.
extern "C" long pq_chunk_attention_smem(int d, int OK, int Ck, int Cv, int bf16_mma, int M, int Mv,
                                        int OV) {
  if (bf16_mma) {
    const long KDP = d + (OK + 15) / 16 * 16;
    return 2 * ((long)(Ck + Cv) * d + (long)MN * (KDP + 8) + (long)d * LDVT) +
           2 * (long)MN * (M + 4 + Mv + 4 + 2 * OK + 2 * OV);
  }
  const long KD = d + OK;
  const long kv = KD * LDK > BN * LDV ? KD * LDK : BN * LDV;
  return 4 * (KD * LDQ + kv + (long)BN * LDP);
}

template <typename K>
static cudaError_t launch(K kernel, const ChunkParams& p, int bs, long smem, long& attr_set,
                          cudaStream_t st) {
  if (smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = smem;
  }
  const dim3 grid((unsigned)((p.QR + BQ - 1) / BQ), (unsigned)p.nh_k, (unsigned)bs);
  kernel<<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D, int OKP>
static cudaError_t launch_mma(const ChunkParams& p, int bs, long smem, cudaStream_t st) {
  static long attr_set = 0;
  return launch(pq_chunk_attention_mma_kernel<D, OKP>, p, bs, smem, attr_set, st);
}

// Launches the kernel on `stream`: grid (ceil(QR / 128), nh_k, bs). bf16_mma
// selects the tensor-core version, built for d in {16, 64, 128} and up to 16
// K outlier channels. Returns a cudaError_t (0 on success); the caller
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
  const long smem = pq_chunk_attention_smem(d, OK, Ck, Cv, bf16_mma, M, Mv, OV);
  if (!bf16_mma) {
    static long attr_set = 0;
    return (int)launch(pq_chunk_attention_kernel, p, bs, smem, attr_set, st);
  }
  const int okp = (OK + 15) / 16 * 16;
  if (d == 128 && okp == 0) return (int)launch_mma<128, 0>(p, bs, smem, st);
  if (d == 128 && okp == 16) return (int)launch_mma<128, 16>(p, bs, smem, st);
  if (d == 64 && okp == 0) return (int)launch_mma<64, 0>(p, bs, smem, st);
  if (d == 64 && okp == 16) return (int)launch_mma<64, 16>(p, bs, smem, st);
  if (d == 16 && okp == 0) return (int)launch_mma<16, 0>(p, bs, smem, st);
  if (d == 16 && okp == 16) return (int)launch_mma<16, 16>(p, bs, smem, st);
  return (int)cudaErrorInvalidValue;
}
