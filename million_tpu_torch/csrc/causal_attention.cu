// Exact causal attention within a prefill chunk: the in-chunk partial of the
// chunked prefill and of the paged admission.
//
// Replaces million_tpu/models/chunked_prefill.py::_causal_partial, which the
// reference writes in plain jnp (XLA fuses it into one program; it is not a
// Pallas kernel). In the port its plain version was a blockwise PyTorch loop
// of some eight elementwise passes over a (rows, 1024) f32 score transient
// per key block, with the blocks above the diagonal computed and then masked.
//
// What it computes, for each (sequence b, KV head h): the G = nh / nh_k query
// heads of the group attend causally over the chunk's own nc keys,
//   s[r, n] = (q[r] * scale) . k[n]  for n <= pos(r), else masked,
//   out[r]  = softmax_n(s[r]) @ v,   lse[r] = logsumexp_n s[r],
// out (bs, nh, nc, d) f32 normalised and lse (bs, nh, nc) f32, what the
// caller LSE-merges with the history partial. No KV head is repeated: a block
// owns 128 rows of one (b, h), ordered row = pos * G + g as the history
// kernel groups them (pq_chunk_attention.cu), so the G heads of a position
// share every K/V tile the block loads. A 128-row block then covers 128 / G
// positions (42 2/3 at G = 3), not a square of the (pos, key) plane, so the
// mask is taken per row: row r sees keys 0 .. r / G. The alternative, rows in
// the plain version's order (g * nc + pos), gives square diagonal tiles but
// reads each K/V tile once per head (through L2); grouping reads it once per
// block. Tiles wholly above the diagonal are skipped: a block walks the keys
// 0 .. pos(last row), and only the tiles that cross the diagonal are masked.
// q, k and v are read through their strides (batch, head, position; dims
// contiguous): q and k are head slices of one rotated tensor and v a
// token-major view, as the model's projection gives them, never copied.
//
// Bound. 2 x 2 x d operations per (row, key) pair under the diagonal, nc (nc
// + 1) / 2 pairs per head: at the chunk shape (bs 4, 24 / 8 heads, nc 4,096,
// d 128) that is 4.1e11, 0.42 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 0.37 GB of bytes (q, k, v in bf16 read once, out and lse in f32
// written once), 0.11 ms at 3.35 TB/s: bound by operations. At the admission
// shape (6 slots x 512 tokens) it is 9.7e9 operations (0.010 ms) against 69
// MB (0.021 ms): bound by bytes, 38 MB of them the f32 out.
//
// Two versions of that function, chosen by the input type:
// - f32 inputs (f32 models, test-tiny, the card's exact reference): CUDA
//   cores, the register-tiled f32 scheme of the history kernel's f32 version
//   with the history decode replaced by plain loads and the causal mask
//   added: 256 threads, 128 rows, 128-key tiles, 8 x 8 micro-tiles. All
//   arithmetic f32, so it differs from its plain version only by summation
//   order.
// - bf16 inputs (16-bit models): tensor cores, the consumer side of the
//   history kernel's tensor-core version without its decode. A producer
//   warpgroup copies 64-key K and V tiles with cp.async, 16 bytes a copy, straight
//   into the layout wgmma reads (8 x 8 core matrices of 128 bytes, no
//   swizzle: byte (g * 64 + key) * 16 holds dims 8 g .. 8 g + 7 of a key),
//   into a ring of four stages with a full and an empty mbarrier each (a
//   thread's copies arrive on the full barrier by themselves when they land,
//   so the consumers never wait for the producer to issue later tiles); keys
//   past nc are zero-filled by the copy. Two consumer warpgroups of 64 rows
//   (setmaxnreg gives them the producers' registers) keep their query
//   fragments in registers and per tile issue S(t) = Q K^T (m64n64k16) and
//   O += P(t - 1) V(t - 1) (m64n{d}k16, P straight from the score registers)
//   as one batch, then mask and run the online softmax of tile t while the
//   other warpgroup's batch runs. Rounding as the plain
//   version on the card: q * scale in f32 rounded to bf16, f32 sums, P =
//   exp(S - running max) rounded to bf16 for the P V product, row sums from
//   the f32 P. d = 64 issues one more score k-step with zero query fragments
//   (it adds exactly 0): with d = 64 the query and P fragments have the same
//   shape, and ptxas of CUDA 12.8 once gave them one set of registers in the
//   history kernel (pq_chunk_attention.cu).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

#define NEG_BIG (-1e30f)

struct CausalParams {
  const void* q;  // (bs, nh, nc, d): f32 or bf16, element strides below, dims contiguous
  const void* k;  // (bs, nh_k, nc, d)
  const void* v;  // (bs, nh_k, nc, d)
  long sqb, sqh, sqn, skb, skh, skn, svb, svh, svn;
  float* out;  // (bs, nh, nc, d) f32, contiguous
  float* lse;  // (bs, nh, nc) f32, contiguous
  int nh_k, G, nc, d, QR;  // QR = nc * G rows per (b, h)
  float scale;
};

// ---------------------------------------------------------------------------
// The f32 version.

#define BQ 128        // query rows per block (both versions)
#define BN 128        // keys per tile
#define THREADS 256   // 16 x 16 threads, an 8 x 8 micro-tile each
#define LDQ BQ        // Qt[k][row]
#define LDK BN        // Kt[k][key]
#define LDV 128       // Vs[key][dim], d <= 128
#define LDP (BQ + 4)  // Pt[key][row], padded against store conflicts
#define MAX_D 128

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

__global__ void __launch_bounds__(THREADS, 1) causal_f32_kernel(CausalParams p) {
  extern __shared__ float4 smem4[];
  const int d = p.d, G = p.G;
  float* Qt = reinterpret_cast<float*>(smem4);  // d * LDQ
  float* KV = Qt + d * LDQ;                     // BN * LDV (>= d * LDK)
  float* Pt = KV + BN * LDV;                    // BN * LDP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest row blocks start first
  const int n_keys = min((min(row0 + BQ, p.QR) - 1) / G + 1, p.nc);  // keys the block's rows see
  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + (long)h * G * p.sqh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;

  // query tile, k-major, scaled; rows past QR are zero
  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, k = i - r * d, row = row0 + r;
    Qt[k * LDQ + r] = row < p.QR ? qg[(row % G) * p.sqh + (row / G) * p.sqn + k] * p.scale : 0.f;
  }
  int pos[8];  // the position of each of this thread's rows
#pragma unroll
  for (int i = 0; i < 8; ++i) pos[i] = (row0 + ((i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4))) / G;

  float acc[8][8], m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = 0; n0 < n_keys; n0 += BN) {
    const int nt = min(BN, n_keys - n0);

    // 1. K of the tile, k-major
    for (int i = tid; i < BN * d; i += THREADS) {
      const int key = i / d, k = i - key * d;
      KV[k * LDK + key] = key < nt ? kg[(long)(n0 + key) * p.skn + k] : 0.f;
    }
    __syncthreads();

    // 2. S = Q Kt, rows {ty*4.., 64 + ty*4..} x keys {tx*4.., 64 + tx*4..}
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(Qt + k * LDQ + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(Qt + k * LDQ + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(KV + k * LDK + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(KV + k * LDK + 64 + tx * 4);
      outer8(s, a0, a1, b0, b1);
    }
    // the causal mask and the tile's ragged end
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int tj = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (tj >= nt || n0 + tj > pos[i]) s[i][j] = -INFINITY;
    }
    // online softmax; key 0 is under every row's diagonal, so from the first
    // tile on the running max is finite
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
      l_run[i] = l_run[i] * alpha + ps;  // this thread's keys; summed at the end
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int tj = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      *reinterpret_cast<float4*>(Pt + tj * LDP + ty * 4) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(Pt + tj * LDP + 64 + ty * 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();  // Kt has been read by all; Pt is complete

    // 3. V of the tile, key-major, over the K buffer
    for (int i = tid; i < BN * d; i += THREADS) {
      const int key = i / d, k = i - key * d;
      KV[key * LDV + k] = key < nt ? vg[(long)(n0 + key) * p.svn + k] : 0.f;
    }
    __syncthreads();

    // 4. acc += P V, rows as above x dims {tx*4.., 64 + tx*4..}
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

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float l = row_sum(l_run[i]);
    const int row = row0 + ((i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= p.QR) continue;
    const long o = ((long)(b * p.nh_k + h) * G + row % G) * p.nc + pos[i];  // (b, head, pos)
    float* og = p.out + o * d;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    if (tx * 4 < d)
      *reinterpret_cast<float4*>(og + tx * 4) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    if (64 + tx * 4 < d)
      *reinterpret_cast<float4*>(og + 64 + tx * 4) =
          make_float4(acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv, acc[i][7] * inv);
    if (tx == 0) p.lse[o] = l > 0.f ? m_run[i] + logf(l) : NEG_BIG;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core version.

#define NT 64                          // keys per tile
#define NCONS 2                        // consumer warpgroups, 64 rows each
#define MQ (64 * NCONS)                // rows per block
#define CONS_THREADS (128 * NCONS)
#define MMA_THREADS (CONS_THREADS + 128)  // and one producer warpgroup
#define PRODUCER_REGS 56               // setmaxnreg moves registers from the producers to the consumers
#define CONSUMER_REGS 216
#define STAGES 4                       // K/V tiles in flight
#define SMEM_HEAD 128                  // the full and empty mbarriers
static_assert(MQ == BQ, "both versions cut the rows into blocks of the same size");
static_assert(SMEM_HEAD >= 2 * STAGES * 8, "mbarriers");
static_assert(128 * PRODUCER_REGS + CONS_THREADS * CONSUMER_REGS <= 65536, "register file");

// shared memory of the tensor-core version: the head, then STAGES stages of a
// K tile and a V tile, NT keys of d bf16 each
static long mma_smem(int d) { return SMEM_HEAD + (long)STAGES * 2 * NT * d * 2; }

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 1) causal_mma_kernel(CausalParams p) {
  constexpr int DG = D / 8;                // 8-dim groups of a key row
  constexpr int KS = D == 64 ? 5 : D / 16;  // k-steps of the score product (see the note on d = 64)
  constexpr int TILE = NT * D * 2;         // bytes of a K or a V tile
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  uint8_t* tiles = smem + SMEM_HEAD;  // stage s: K at s * 2 * TILE, V right after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.G, h = blockIdx.y, b = blockIdx.z;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * MQ;  // the longest row blocks start first
  const int n_keys = min((min(row0 + MQ, p.QR) - 1) / G + 1, p.nc);  // keys the block's rows see
  const int n_tiles = (n_keys + NT - 1) / NT;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 128);            // the producer threads, once their copies of a tile landed
      mbar_init(empty + s, CONS_THREADS);  // the consumers' threads, once P V of the tile is done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONS * 4) {
    // ---- the producer warpgroup: tile t into stage t % STAGES ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lp = tid - CONS_THREADS;
    const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + h * p.skh;
    const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + h * p.svh;
    auto load = [&](int tile) {
      uint8_t* kt = tiles + (tile % STAGES) * 2 * TILE;
      // copy c: key (c & 7) + 8 * ((c >> 3) / DG), group (c >> 3) % DG. Eight
      // neighbouring lanes fill one core matrix (128 bytes, no bank conflict)
      // and a warp reads four neighbouring groups of eight keys (whole sectors).
      for (int c = lp; c < NT * DG; c += 128) {
        const int key = (c & 7) + 8 * ((c >> 3) / DG), g = (c >> 3) % DG, n = tile * NT + key;
        const bool live = n < p.nc;
        const long nn = live ? n : 0;
        const int off = (g * NT + key) * 16;
        cp_async16(kt + off, kg + nn * p.skn + g * 8, live ? 16 : 0);
        cp_async16(kt + TILE + off, vg + nn * p.svn + g * 8, live ? 16 : 0);
      }
    };
    // Each thread's copies of a tile arrive on the stage's full barrier by
    // themselves when they land (cp.async.mbarrier.arrive), so a consumer
    // never waits for the producer to issue later tiles first.
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(empty + t % STAGES, ((t / STAGES) & 1) ^ 1);  // the first pass finds every stage free
      load(t);
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(full + t % STAGES))
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int gq = lane >> 2, t4 = lane & 3;
    const int row_a = row0 + (warp >> 2) * 64 + (warp & 3) * 16 + gq, row_b = row_a + 8;
    const int pos_a = row_a / G, pos_b = row_b / G;
    const bool live_a = row_a < p.QR, live_b = row_b < p.QR;
    // row r is (head h * G + r % G, position r / G)
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + (long)h * G * p.sqh;
    const __nv_bfloat16* q_a = qg + (row_a - pos_a * G) * p.sqh + (long)pos_a * p.sqn;
    const __nv_bfloat16* q_b = qg + (row_b - pos_b * G) * p.sqh + (long)pos_b * p.sqn;
    auto qx = [&](const __nv_bfloat16* qr, bool live, int k) -> float {  // q * scale in f32; zero past
      return live && k < D ? __bfloat162float(qr[k]) * p.scale : 0.f;   // the rows and past d
    };
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k0 = ks * 16 + t4 * 2;
      qa[ks][0] = pack_bf16(qx(q_a, live_a, k0), qx(q_a, live_a, k0 + 1));
      qa[ks][1] = pack_bf16(qx(q_b, live_b, k0), qx(q_b, live_b, k0 + 1));
      qa[ks][2] = pack_bf16(qx(q_a, live_a, k0 + 8), qx(q_a, live_a, k0 + 9));
      qa[ks][3] = pack_bf16(qx(q_b, live_b, k0 + 8), qx(q_b, live_b, k0 + 9));
    }
    float oacc[D / 2], sacc[NT / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) sacc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    const float L2E = 1.4426950408889634f;
    uint32_t pa[NT / 16][4];  // P of the previous tile as the A operand: keys 16 kk .. 16 kk + 15

    // Iteration it issues S(it) = Q K(it)^T and O += P(it - 1) V(it - 1) as
    // one batch, hands stage it - 1 back once it is done, then masks and runs
    // the softmax of tile it while the other consumer warpgroup's batch runs.
    // The mask and the rescale are written without branches: a divergent
    // write to wgmma's registers makes ptxas serialise the products.
    for (int it = 0; it <= n_tiles; ++it) {
      const bool has_s = it < n_tiles, has_pv = it > 0;
      const int s = it % STAGES, sp = (it + STAGES - 1) % STAGES;
      if (has_s) {
        mbar_wait(full + s, (it / STAGES) & 1);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the copies, visible to wgmma
      }
      // K: K-major, core matrices NT * 16 bytes apart along K (dims), 128
      // along N (keys); V: MN-major, 128 bytes apart along K (keys), NT * 16
      // along N (dims)
      const uint64_t dk = smem_desc(tiles + s * 2 * TILE, NT * 16, 128);
      const uint64_t dv = smem_desc(tiles + sp * 2 * TILE + TILE, 128, NT * 16);
      reg_fence(sacc);
      reg_fence(oacc);
      wgmma_fence();
      if (has_s) {
        // S: register sacc[4 i + 2 h + j] holds row (h ? row_b : row_a), key 8 i + 2 t4 + j
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int kss = ks < D / 16 ? ks : 0;  // the zero step of d = 64 rereads dims 0-15
          wgmma_s64(sacc, qa[ks], dk + (uint64_t)((kss * 2 * NT * 16) >> 4), ks > 0);
        }
      }
      if (has_pv) {
#pragma unroll
        for (int kk = 0; kk < NT / 16; ++kk) wgmma_pv<D>(oacc, pa[kk], dv + (uint64_t)((kk * 2 * 128) >> 4));
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(sacc);
      reg_fence(oacc);
      if (has_pv) mbar_arrive(empty + sp);
      if (!has_s) break;

      // the causal mask; keys past nc are past every real row's diagonal
      const int n0 = it * NT;
#pragma unroll
      for (int i = 0; i < NT / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = n0 + i * 8 + t4 * 2 + j;
          sacc[4 * i + j] = key > pos_a ? -INFINITY : sacc[4 * i + j];
          sacc[4 * i + 2 + j] = key > pos_b ? -INFINITY : sacc[4 * i + 2 + j];
        }
      // online softmax over rows row_a and row_b; key 0 is under every row's
      // diagonal, so from the first tile on the running max is finite
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
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
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
      l_a = l_a * al_a + ps_a;  // this lane's keys; summed over the row's lanes at the end
      l_b = l_b * al_b + ps_b;
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      // the sums now hold P(it - 1) V(it - 1): onto the new running max
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        oacc[4 * i] *= al_a;
        oacc[4 * i + 1] *= al_a;
        oacc[4 * i + 2] *= al_b;
        oacc[4 * i + 3] *= al_b;
      }
    }

#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
    }
    const long o_a = ((long)(b * p.nh_k + h) * G + row_a - pos_a * G) * p.nc + pos_a;
    const long o_b = ((long)(b * p.nh_k + h) * G + row_b - pos_b * G) * p.nc + pos_b;
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f, inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + t4 * 2;
      if (live_a)
        *reinterpret_cast<float2*>(p.out + o_a * D + col) = make_float2(oacc[4 * i] * inv_a, oacc[4 * i + 1] * inv_a);
      if (live_b)
        *reinterpret_cast<float2*>(p.out + o_b * D + col) =
            make_float2(oacc[4 * i + 2] * inv_b, oacc[4 * i + 3] * inv_b);
    }
    if (t4 == 0) {
      if (live_a) p.lse[o_a] = l_a > 0.f ? m_a + logf(l_a) : NEG_BIG;
      if (live_b) p.lse[o_b] = l_b > 0.f ? m_b + logf(l_b) : NEG_BIG;
    }
  }
}

extern "C" int causal_attention_q_block() { return BQ; }

extern "C" int causal_attention_key_tile(int bf16_mma) { return bf16_mma ? NT : BN; }

// Shared memory one block needs, in bytes (the wrapper holds its mirror,
// causal_smem_plan, against it). bf16_mma selects the tensor-core version.
extern "C" long causal_attention_smem(int d, int bf16_mma) {
  if (bf16_mma) return mma_smem(d);
  return 4L * (d * LDQ + BN * LDV + BN * LDP);
}

static cudaError_t set_smem(const void* kernel, long smem, long& attr_set) {
  if (smem <= attr_set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) attr_set = smem;
  return e;
}

template <int D>
static cudaError_t launch_mma(const CausalParams& p, int bs, cudaStream_t st) {
  static long attr_set = 0;
  const long smem = mma_smem(D);
  auto kernel = causal_mma_kernel<D>;
  cudaError_t e = set_smem((const void*)kernel, smem, attr_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((p.QR + MQ - 1) / MQ), (unsigned)p.nh_k, (unsigned)bs);
  kernel<<<grid, MMA_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// Launches the kernel on `stream`: grid (ceil(nc * G / 128), nh_k, bs).
// Strides are in elements, dims contiguous. bf16_mma selects the
// tensor-core version (bf16 q, k, v; d in {16, 64, 128}; 16-byte aligned k
// and v rows), else the f32 version (f32 q, k, v; d <= 128, d % 4 == 0).
// Returns a cudaError_t (0 on success); the caller validates shapes and types.
extern "C" int causal_attention(const void* q, const void* k, const void* v, void* out, void* lse,
                                long sqb, long sqh, long sqn, long skb, long skh, long skn, long svb,
                                long svh, long svn, int bs, int nh_k, int G, int nc, int d, float scale,
                                int bf16_mma, void* stream) {
  CausalParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.sqb = sqb; p.sqh = sqh; p.sqn = sqn;
  p.skb = skb; p.skh = skh; p.skn = skn;
  p.svb = svb; p.svh = svh; p.svn = svn;
  p.out = (float*)out;
  p.lse = (float*)lse;
  p.nh_k = nh_k; p.G = G; p.nc = nc; p.d = d; p.QR = nc * G;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (!bf16_mma) {
    if (d > MAX_D || d % 4) return (int)cudaErrorInvalidValue;
    static long attr_set = 0;
    const long smem = causal_attention_smem(d, 0);
    cudaError_t e = set_smem((const void*)causal_f32_kernel, smem, attr_set);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((p.QR + BQ - 1) / BQ), (unsigned)nh_k, (unsigned)bs);
    causal_f32_kernel<<<grid, THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  if (d == 128) return (int)launch_mma<128>(p, bs, st);
  if (d == 64) return (int)launch_mma<64>(p, bs, st);
  if (d == 16) return (int)launch_mma<16>(p, bs, st);
  return (int)cudaErrorInvalidValue;
}
