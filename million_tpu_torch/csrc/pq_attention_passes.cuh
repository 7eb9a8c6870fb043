// The three passes of PQ decode attention, shared by pq_decode_attention.cu
// (flat, token-major code arena) and pq_paged_attention.cu (page pools read
// through a per-sequence page table). The kernels are templates on PAGED;
// the two differ only in where a block finds its tokens:
//   flat:  every sequence has the same n_codes (a host integer), token n of
//          (b, h) is row ((b * nh_k + h) * N_max + n) of the arena;
//   paged: sequence b has its own n_codes[b] (read from device memory by the
//          block), and token n is row (n % page_size) of head h of page
//          page_table[b, n / page_size] of the pool. A tile of TILE tokens
//          never straddles a page (page_size % TILE == 0), so the page id is
//          looked up once per tile, by the block itself.
//
//   pq_score_kernel: the scores of every token (f32, to a scratch row per
//     (b, h)) and each split's softmax max and sum, with the K codebook in
//     shared memory.
//   pq_value_kernel: P @ V per split from those scores, with the V codebook
//     in shared memory, V decoded on the fly.
//   pq_reduce_kernel: the LSE-merge of the splits and of the exact residual
//     window, whose live row count is a host integer or one device integer
//     per sequence, its rows read by the whole block at once.
// The tiles of code rows (and outlier rows, and scores) are copied into
// shared memory with cp.async, double-buffered, so the next tile's copy (in
// paged mode: from the next page) is in flight while the current one is
// computed. All arithmetic is f32.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#define TILE 256      // tokens per tile
#define THREADS 512   // threads per block: two per token in the score pass
#define NEG_BIG (-1e30f)

struct Params {
  const float* q;              // (bs, nh_k, G, d) f32, pre-scaled
  const uint8_t* kcodes;       // flat (bs, nh_k, N_max, M); paged (pages, nh_k, page_size, M)
  const uint8_t* vcodes;       // the same with Mv
  const float* kcent;          // (M, Ck, dmk) f32
  const float* vcent;          // (Mv, Cv, dmv) f32
  const __nv_bfloat16* kout;   // exact K channels, laid out as kcodes with OK, or null
  const __nv_bfloat16* vout;   // exact V channels, laid out as vcodes with OV, or null
  const int* koidx;            // (OK,) int32 or null
  const int* voidx;            // (OV,) int32 or null
  float* scores;               // (bs, nh_k, srow_len, G) f32 scratch
  float* ml_part;              // (bs, nh_k, S, G, 2) f32 scratch: split max, sum
  float* out_part;             // (bs, nh_k, S, G, d) f32
  float* lse_part;             // (bs, nh_k, S, G) f32
  int nh_k, d, M, Ck, dmk, Mv, Cv, dmv, OK, OV, S;
  int srow_len;                // tokens per (b, h) row of `scores`
  int cent_in_smem;            // the pass's codebook sits in shared memory
  int rs;                      // shared-memory row stride of the pass's code tiles (bytes)
  int kwide, vwide;            // the passes' builds: any d_m and M (1), or d_m <= 8, M % 4 == 0 (0)
  // flat mode
  int N_max, n_codes, chunk;
  // paged mode
  const int* page_table;       // (bs, P_max) int32, -1 = unallocated
  const int* seq_n_codes;      // (bs,) int32
  int P_max, page_size;
  int n_bound;                 // host bound on every n_codes[b], <= P_max * page_size
  int fixed_chunk;             // tokens per split when > 0, else the block cuts n_codes[b] into S
};

// Row stride for a tile of code rows read with 16-byte loads, one row per
// thread: a multiple of 16 bytes that is an odd number of 16-byte chunks,
// so eight consecutive rows fall in distinct bank groups.
static int code_row_stride(int m) {
  int rs = (m + 15) / 16 * 16;
  if ((rs / 16) % 2 == 0) rs += 16;
  return rs;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy nt rows of rb bytes (global rows contiguous) into shared rows of
// stride rs, in 16-byte pieces when rb allows, else 4-byte pieces. ANY_RB
// (the wide instantiations) also takes rb % 4 != 0 (fewer than 4 subspaces,
// or a count that is not a multiple of 4): those rows go byte by byte with
// plain loads and stores, visible after the barrier that every reader passes.
template <bool ANY_RB = false>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* src, int nt, int rb, int rs) {
  if (ANY_RB && rb % 4 != 0) {
    for (int i = threadIdx.x; i < nt * rb; i += THREADS) {
      const int r = i / rb, c = i - r * rb;
      dst[r * rs + c] = __ldg(src + (long)r * rb + c);
    }
  } else if (rb % 16 == 0) {
    const int per = rb / 16;
    for (int i = threadIdx.x; i < nt * per; i += THREADS) {
      const int r = i / per, c = i - r * per;
      cp_async16(dst + r * rs + c * 16, src + (long)r * rb + c * 16);
    }
  } else {
    const int per = rb / 4;
    for (int i = threadIdx.x; i < nt * per; i += THREADS) {
      const int r = i / per, c = i - r * per;
      cp_async4(dst + r * rs + c * 4, src + (long)r * rb + c * 4);
    }
  }
}

// Copy `bytes` contiguous bytes (whole bf16 values) from src into shared
// memory at dst + (src & 15), dst 16-byte aligned, and return that address:
// the 16-byte-aligned body in 16-byte cp.async pieces, the head before it
// and the tail after it (under 16 bytes each) by plain 2-byte loads of the
// last 16 threads. A tile of outlier rows is one such span (rows of any OK *
// 2 bytes lie back to back), so any OK works; its slot takes bytes + 16.
__device__ __forceinline__ const uint8_t* copy_span(uint8_t* dst, const uint8_t* src, int bytes) {
  const int lead = (int)((uintptr_t)src & 15);
  uint8_t* out = dst + lead;
  const int head = min(bytes, (16 - lead) & 15);
  const int body = (bytes - head) / 16;
  const int tail0 = head + body * 16;
  for (int i = threadIdx.x; i < body; i += THREADS) cp_async16(out + head + i * 16, src + head + i * 16);
  const int n_head = head / 2, n_tail = (bytes - tail0) / 2;  // at most 7 each
  const int t = (int)threadIdx.x - (THREADS - 16);
  if (t >= 0 && t < n_head + n_tail) {
    const int off = t < n_head ? 2 * t : tail0 + 2 * (t - n_head);
    *reinterpret_cast<unsigned short*>(out + off) = __ldg(reinterpret_cast<const unsigned short*>(src + off));
  }
  return out;
}

// Bytes of one shared slot of a tile's outlier rows (copy_span's span and
// its lead); 0 without outliers.
__host__ __device__ __forceinline__ int outlier_slot(int o) { return o > 0 ? TILE * 2 * o + 16 : 0; }

// The value pass's columns (see pq_value_kernel): dims of a subspace slice
// held in registers, and the number of thread groups that split a tile's
// tokens. The host sizes the groups' slabs of partial sums from it.
__host__ __device__ constexpr int value_slice_width(int DM, int G) { return (DM == 16 && G > 3) ? 8 : DM; }

__host__ __device__ __forceinline__ int value_groups(int DM, int G, int Mv, int dmv, int OV) {
  const int sw = value_slice_width(DM, G);
  const int nsl = DM == 8 ? 1 : (dmv + sw - 1) / sw;
  const int cpad = (Mv * nsl + OV + 31) / 32 * 32;
  return THREADS / cpad;
}

__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  // n is a multiple of 4 and both pointers are 16-byte aligned
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 4; i += THREADS) d4[i] = __ldg(s4 + i);
}

// The tokens [start, end) of sequence b that split `split` owns. Paged: the
// block reads its sequence's own length and, unless the split length is
// fixed, cuts it into S splits of whole tiles, so a short sequence beside a
// long one still spreads over its S blocks.
template <bool PAGED>
__device__ __forceinline__ void split_span(const Params& p, int b, int split, int& start, int& end) {
  if constexpr (PAGED) {
    const int n = min(p.seq_n_codes[b], p.n_bound);
    int chunk = p.fixed_chunk;
    if (chunk <= 0) chunk = max(TILE, ((n + p.S - 1) / p.S + TILE - 1) / TILE * TILE);
    start = split * chunk;
    end = min(start + chunk, n);
  } else {
    start = split * p.chunk;
    end = min(start + p.chunk, p.n_codes);
  }
}

// The rows of rb bytes that hold tokens n0, n0 + 1, ... of (b, h); n0 is a
// multiple of TILE. Paged: the page id comes from the block's own read of
// the table (-1 clamps to page 0; such tokens lie beyond n_codes[b]).
template <bool PAGED>
__device__ __forceinline__ const uint8_t* token_rows(const Params& p, const void* base, int b, int h,
                                                     int n0, int rb) {
  const uint8_t* rows = reinterpret_cast<const uint8_t*>(base);
  if constexpr (PAGED) {
    const int page = max(p.page_table[b * p.P_max + n0 / p.page_size], 0);
    return rows + (((long)page * p.nh_k + h) * p.page_size + n0 % p.page_size) * rb;
  } else {
    return rows + (((long)b * p.nh_k + h) * p.N_max + n0) * rb;
  }
}

// s[g] += q[g, dim] * v for the GQ groups of four query rows.
template <int GQ>
__device__ __forceinline__ void fma_dim(float (&s)[4 * GQ], const float4* qt4, int dim, float v) {
#pragma unroll
  for (int j = 0; j < GQ; ++j) {
    const float4 qv = qt4[dim * GQ + j];
    s[4 * j + 0] = fmaf(qv.x, v, s[4 * j + 0]);
    s[4 * j + 1] = fmaf(qv.y, v, s[4 * j + 1]);
    s[4 * j + 2] = fmaf(qv.z, v, s[4 * j + 2]);
    s[4 * j + 3] = fmaf(qv.w, v, s[4 * j + 3]);
  }
}

template <int GQ>
__device__ __forceinline__ void score_code(float (&s)[4 * GQ], const float4* qt4, const float* kc,
                                           int m, int c, int M, int Ck, int dmk) {
  const float* cent = kc + ((long)m * Ck + c) * dmk;
  if (dmk == 2) {
    const float2 cv = *reinterpret_cast<const float2*>(cent);
    fma_dim<GQ>(s, qt4, m, cv.x);
    fma_dim<GQ>(s, qt4, m + M, cv.y);
  } else if (dmk == 4) {
    const float4 cv = *reinterpret_cast<const float4*>(cent);
    fma_dim<GQ>(s, qt4, m, cv.x);
    fma_dim<GQ>(s, qt4, m + M, cv.y);
    fma_dim<GQ>(s, qt4, m + 2 * M, cv.z);
    fma_dim<GQ>(s, qt4, m + 3 * M, cv.w);
  } else {
    for (int t = 0; t < dmk; ++t) fma_dim<GQ>(s, qt4, m + t * M, cent[t]);
  }
}

// The wide instantiation's term of one code: any subspace width, in float4
// pieces where it is a multiple of 4 (d_m 16, 32, 64, 128), else one float
// at a time.
template <int GQ>
__device__ __forceinline__ void score_code_wide(float (&s)[4 * GQ], const float4* qt4, const float* kc,
                                                int m, int c, int M, int Ck, int dmk) {
  const float* cent = kc + ((long)m * Ck + c) * dmk;
  if (dmk % 4 == 0) {
    const float4* c4 = reinterpret_cast<const float4*>(cent);
    for (int t = 0; t < dmk; t += 4) {
      const float4 cv = c4[t / 4];
      fma_dim<GQ>(s, qt4, m + t * M, cv.x);
      fma_dim<GQ>(s, qt4, m + (t + 1) * M, cv.y);
      fma_dim<GQ>(s, qt4, m + (t + 2) * M, cv.z);
      fma_dim<GQ>(s, qt4, m + (t + 3) * M, cv.w);
    }
  } else {
    for (int t = 0; t < dmk; ++t) fma_dim<GQ>(s, qt4, m + t * M, cent[t]);
  }
}

// Pass 1: scores of the split's tokens to p.scores, and the split's softmax
// max and sum to p.ml_part. WIDE = false is the build of d_m <= 8 with M % 4
// == 0 (every main path); WIDE = true takes any subspace width and any M
// (the code rows read byte by byte where M % 4 != 0).
template <int G, bool WIDE, bool PAGED>
__global__ void __launch_bounds__(THREADS, 1) pq_score_kernel(Params p) {
  constexpr int GQ = (G + 3) / 4;  // groups of four query rows
  constexpr int GP = 4 * GQ;       // padded query rows
  constexpr int NW = THREADS / 32;
  extern __shared__ float4 smem4[];
  uint8_t* ptr = reinterpret_cast<uint8_t*>(smem4);
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = p.d, M = p.M, OK = p.OK;

  const float* kc = p.kcent;
  if (p.cent_in_smem) { kc = reinterpret_cast<float*>(ptr); ptr += (size_t)p.Ck * d * 4; }
  uint8_t* kbuf = ptr;  ptr += 2 * TILE * p.rs;
  const int okb = OK * 2, kos = outlier_slot(OK);  // outlier row bytes, slot bytes
  uint8_t* kobuf = ptr; ptr += 2 * kos;
  float* qt = reinterpret_cast<float*>(ptr);  ptr += d * GP * 4;  // qt[dim][GP]
  float* qot = reinterpret_cast<float*>(ptr); ptr += (OK > 0 ? OK : 1) * GP * 4;
  float* red_s = reinterpret_cast<float*>(ptr);

  const long bh = (long)b * p.nh_k + h;
  int start, end;
  split_span<PAGED>(p, b, split, start, end);
  float* srow = p.scores + bh * (long)p.srow_len * G;

  const uint8_t* ko_tile[2] = {kobuf, kobuf + kos};  // each slot's first outlier row
  auto prefetch = [&](int buf, int n0) {
    const int nt = min(TILE, end - n0);
    copy_rows<WIDE>(kbuf + buf * TILE * p.rs, token_rows<PAGED>(p, p.kcodes, b, h, n0, M), nt, M, p.rs);
    if (p.kout) {
      const uint8_t* at = copy_span(kobuf + buf * kos, token_rows<PAGED>(p, p.kout, b, h, n0, okb), nt * okb);
      if (buf) ko_tile[1] = at; else ko_tile[0] = at;
    }
    cp_async_commit();
  };
  if (start < end) prefetch(0, start);
  if (p.cent_in_smem) stage(const_cast<float*>(kc), p.kcent, p.Ck * d);
  for (int i = tid; i < d * GP; i += THREADS) {
    const int dim = i / GP, g = i % GP;
    qt[i] = g < G ? p.q[(bh * G + g) * d + dim] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < OK * GP; i += THREADS) qot[i] = qt[p.koidx[i / GP] * GP + i % GP];
  // (visible to the score loop after the first tile's barrier)
  const float4* qt4 = reinterpret_cast<const float4*>(qt);
  const float4* qot4 = reinterpret_cast<const float4*>(qot);

  float m_run[G], l_run[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
  }
  // threads 2t and 2t+1 score token n0 + t, each over part of the
  // subspaces (the second also adds the outlier term)
  const int t_me = tid >> 1, half = tid & 1;
  const int msplit = (M % 8 == 0) ? M / 2 : M;
  const int m_lo = half ? msplit : 0, m_hi = half ? M : msplit;

  int buf = 0;
  for (int n0 = start; n0 < end; n0 += TILE, buf ^= 1) {
    const int nt = min(TILE, end - n0);
    if (n0 + TILE < end) {
      prefetch(buf ^ 1, n0 + TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) s[g] = 0.f;
    if (t_me < nt) {
      const uint8_t* row = kbuf + buf * TILE * p.rs + t_me * p.rs;
      if constexpr (WIDE) {
        if (M % 4 == 0) {
          for (int m0 = m_lo; m0 < m_hi; m0 += 4) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(row + m0);
            for (int k = 0; k < 4; ++k)
              score_code_wide<GQ>(s, qt4, kc, m0 + k, (w >> (8 * k)) & 0xFF, M, p.Ck, p.dmk);
          }
        } else {
          for (int m = m_lo; m < m_hi; ++m) score_code_wide<GQ>(s, qt4, kc, m, row[m], M, p.Ck, p.dmk);
        }
      } else if (msplit % 16 == 0) {
        for (int m0 = m_lo; m0 < m_hi; m0 += 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(row + m0);
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int k = 0; k < 16; ++k)
            score_code<GQ>(s, qt4, kc, m0 + k, (ws[k >> 2] >> (8 * (k & 3))) & 0xFF, M, p.Ck, p.dmk);
        }
      } else {
        for (int m0 = m_lo; m0 < m_hi; m0 += 4) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(row + m0);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            score_code<GQ>(s, qt4, kc, m0 + k, (w >> (8 * k)) & 0xFF, M, p.Ck, p.dmk);
        }
      }
      if (p.kout && half) {
        const __nv_bfloat16* ko = reinterpret_cast<const __nv_bfloat16*>(buf ? ko_tile[1] : ko_tile[0]) + t_me * OK;
        for (int o = 0; o < OK; ++o) fma_dim<GQ>(s, qot4, o, __bfloat162float(ko[o]));
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
      if (t_me >= nt) s[g] = -INFINITY;
    }
    if (t_me < nt && !half) {
#pragma unroll
      for (int g = 0; g < G; ++g) srow[(long)(n0 + t_me) * G + g] = s[g];
    }
    // online max and sum over the tile
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float v = warp_max(s[g]);
      if (lane == 0) red_s[g * NW + warp] = v;
    }
    __syncthreads();
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = red_s[g * NW];
#pragma unroll
      for (int w = 1; w < NW; ++w) mx = fmaxf(mx, red_s[g * NW + w]);
      const float m_new = fmaxf(m_run[g], mx);  // finite: the tile has a token
      alpha[g] = expf(m_run[g] - m_new);
      m_run[g] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float e = (t_me < nt && !half) ? expf(s[g] - m_run[g]) : 0.f;
      const float v = warp_sum(e);
      if (lane == 0) red_s[g * NW + warp] = v;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += red_s[g * NW + w];
      l_run[g] = l_run[g] * alpha[g] + sum;
    }
    __syncthreads();  // red_s and this buffer are rewritten next tile
  }
  if (tid < G) {
    const bool empty = start >= end;
    float m = NEG_BIG, l = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g == tid && !empty) { m = m_run[g]; l = l_run[g]; }
    float* ml = p.ml_part + ((bh * p.S + split) * G + tid) * 2;
    ml[0] = m;
    ml[1] = l;
  }
}

// Pass 2: P @ V over the split, V decoded on the fly, normalised by the
// split's sum; writes the split's (out, lse).
//
// A thread owns one column (a subspace, or an exact outlier channel) for one
// group of the tile's tokens and keeps that column's dims of the G query rows
// in registers, acc[G][SW]. DM is the build's width:
//   DM = 8:  d_m <= 8 with M_v % 4 == 0 (every main path): one column per
//            subspace, SW = 8 registers a row, d_m 2 and 4 read as one
//            float2 / float4, other widths up to 8 one float at a time;
//   DM = 16: every other width (d_m 16 natively, 32 / 64 / 128 as slices):
//            a column is a slice of SW dims of one subspace, SW = 16 for G <=
//            3 and 8 above (acc stays at most 64 floats a thread; G = 4 at 16
//            spilled), read as float4s where d_m % 16 == 0, else one float
//            at a time; the code rows may have any M_v.
template <int G, int DM, bool PAGED>
__global__ void __launch_bounds__(THREADS, 1) pq_value_kernel(Params p) {
  static_assert(DM == 8 || DM == 16, "the value pass is built for DM 8 and 16");
  constexpr int GQ = (G + 3) / 4;
  constexpr int GP = 4 * GQ;
  constexpr int SW = value_slice_width(DM, G);  // dims of a column in registers
  extern __shared__ float4 smem4[];
  uint8_t* ptr = reinterpret_cast<uint8_t*>(smem4);
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int d = p.d, Mv = p.Mv, OV = p.OV;
  const long bh = (long)b * p.nh_k + h;
  const long base = bh * p.S + split;
  int start, end;
  split_span<PAGED>(p, b, split, start, end);
  if (start >= end) {  // empty split: no barrier below is reached
    for (int i = tid; i < G * d; i += THREADS) p.out_part[base * G * d + i] = 0.f;
    if (tid < G) p.lse_part[base * G + tid] = NEG_BIG;
    return;
  }

  float* o_s = reinterpret_cast<float*>(ptr); ptr += (G * d + 3) / 4 * 16;
  float* co_s = reinterpret_cast<float*>(ptr); ptr += (G * (OV > 0 ? OV : 1) * 4 + 15) / 16 * 16;
  // the thread groups' partial sums, written over the space of the codebook
  // and tiles below once the last tile is done (the host sizes it for both)
  float* slab = reinterpret_cast<float*>(ptr);
  const float* vc = p.vcent;
  if (p.cent_in_smem) { vc = reinterpret_cast<float*>(ptr); ptr += (size_t)p.Cv * d * 4; }
  uint8_t* vbuf = ptr;  ptr += 2 * TILE * p.rs;
  const int ovb = OV * 2, vos = outlier_slot(OV);
  uint8_t* vobuf = ptr; ptr += 2 * vos;
  const int sb = G * 4;  // score row bytes
  uint8_t* sbuf = ptr;  ptr += (2 * TILE * sb + 15) / 16 * 16;
  float* p_s = reinterpret_cast<float*>(ptr);  // p_s[t][GP]

  const uint8_t* sg = reinterpret_cast<const uint8_t*>(p.scores + bh * (long)p.srow_len * G);

  const uint8_t* vo_tile[2] = {vobuf, vobuf + vos};
  auto prefetch = [&](int buf, int n0) {
    const int nt = min(TILE, end - n0);
    copy_rows<(DM == 16)>(vbuf + buf * TILE * p.rs, token_rows<PAGED>(p, p.vcodes, b, h, n0, Mv), nt, Mv, p.rs);
    if (p.vout) {
      const uint8_t* at = copy_span(vobuf + buf * vos, token_rows<PAGED>(p, p.vout, b, h, n0, ovb), nt * ovb);
      if (buf) vo_tile[1] = at; else vo_tile[0] = at;
    }
    copy_rows(sbuf + buf * TILE * sb, sg + (long)n0 * sb, nt, sb, sb);
    cp_async_commit();
  };
  prefetch(0, start);
  if (p.cent_in_smem) stage(const_cast<float*>(vc), p.vcent, p.Cv * d);
  float m_s[G], l_s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_s[g] = p.ml_part[(base * G + g) * 2];
    l_s[g] = p.ml_part[(base * G + g) * 2 + 1];
  }
  const float4* p4 = reinterpret_cast<const float4*>(p_s);

  // column col in [0, Mv * nsl) is slice col % nsl of subspace col / nsl,
  // [Mv * nsl, Mv * nsl + OV) an exact outlier channel; ngrp thread groups
  // split the tile's tokens.
  const int dmv = p.dmv;
  const int nsl = DM == 8 ? 1 : (dmv + SW - 1) / SW;
  const int nsub = Mv * nsl;
  const int ncol = nsub + OV;
  const int cpad = (ncol + 31) / 32 * 32;
  const int ngrp = value_groups(DM, G, Mv, dmv, OV);
  const int col = tid % cpad, grp = tid / cpad;
  const bool col_ok = col < ncol && grp < ngrp;
  const int m_col = col / nsl, sl = col - m_col * nsl;  // the column's subspace and slice
  float acc[G][SW];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < SW; ++j) acc[g][j] = 0.f;

  int buf = 0;
  for (int n0 = start; n0 < end; n0 += TILE, buf ^= 1) {
    const int nt = min(TILE, end - n0);
    if (n0 + TILE < end) {
      prefetch(buf ^ 1, n0 + TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tid < TILE) {  // weights of the tile's tokens
      const float* st = reinterpret_cast<const float*>(sbuf + buf * TILE * sb) + tid * G;
#pragma unroll
      for (int g = 0; g < GP; ++g)
        p_s[tid * GP + g] = (g < G && tid < nt) ? expf(st[g < G ? g : 0] - m_s[g < G ? g : 0]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      const uint8_t* vb = vbuf + buf * TILE * p.rs;
      if (col < nsub) {
        const float* vcol = vc + (long)m_col * p.Cv * dmv + sl * SW;
        if constexpr (DM == 8) {
#pragma unroll 4
          for (int t = grp; t < nt; t += ngrp) {
            float pg[GP];
#pragma unroll
            for (int j = 0; j < GQ; ++j) {
              const float4 pv = p4[t * GQ + j];
              pg[4 * j] = pv.x; pg[4 * j + 1] = pv.y; pg[4 * j + 2] = pv.z; pg[4 * j + 3] = pv.w;
            }
            const float* cent = vcol + vb[t * p.rs + col] * dmv;
            if (dmv == 2) {
              const float2 cv = *reinterpret_cast<const float2*>(cent);
#pragma unroll
              for (int g = 0; g < G; ++g) {
                acc[g][0] = fmaf(pg[g], cv.x, acc[g][0]);
                acc[g][1] = fmaf(pg[g], cv.y, acc[g][1]);
              }
            } else if (dmv == 4) {
              const float4 cv = *reinterpret_cast<const float4*>(cent);
#pragma unroll
              for (int g = 0; g < G; ++g) {
                acc[g][0] = fmaf(pg[g], cv.x, acc[g][0]);
                acc[g][1] = fmaf(pg[g], cv.y, acc[g][1]);
                acc[g][2] = fmaf(pg[g], cv.z, acc[g][2]);
                acc[g][3] = fmaf(pg[g], cv.w, acc[g][3]);
              }
            } else {
#pragma unroll
              for (int j = 0; j < DM; ++j) {
                if (j < dmv) {
                  const float cv = cent[j];
#pragma unroll
                  for (int g = 0; g < G; ++g) acc[g][j] = fmaf(pg[g], cv, acc[g][j]);
                }
              }
            }
          }
        } else if (dmv % 16 == 0) {  // whole slices of SW dims, float4 reads
#pragma unroll 2
          for (int t = grp; t < nt; t += ngrp) {
            float pg[GP];
#pragma unroll
            for (int j = 0; j < GQ; ++j) {
              const float4 pv = p4[t * GQ + j];
              pg[4 * j] = pv.x; pg[4 * j + 1] = pv.y; pg[4 * j + 2] = pv.z; pg[4 * j + 3] = pv.w;
            }
            const float4* c4 = reinterpret_cast<const float4*>(vcol + vb[t * p.rs + m_col] * dmv);
#pragma unroll
            for (int q = 0; q < SW / 4; ++q) {
              const float4 cv = c4[q];
#pragma unroll
              for (int g = 0; g < G; ++g) {
                acc[g][4 * q + 0] = fmaf(pg[g], cv.x, acc[g][4 * q + 0]);
                acc[g][4 * q + 1] = fmaf(pg[g], cv.y, acc[g][4 * q + 1]);
                acc[g][4 * q + 2] = fmaf(pg[g], cv.z, acc[g][4 * q + 2]);
                acc[g][4 * q + 3] = fmaf(pg[g], cv.w, acc[g][4 * q + 3]);
              }
            }
          }
        } else {  // a width that is not a multiple of 16: the slice's live dims one at a time
          const int live = min(SW, dmv - sl * SW);
          for (int t = grp; t < nt; t += ngrp) {
            float pg[GP];
#pragma unroll
            for (int j = 0; j < GQ; ++j) {
              const float4 pv = p4[t * GQ + j];
              pg[4 * j] = pv.x; pg[4 * j + 1] = pv.y; pg[4 * j + 2] = pv.z; pg[4 * j + 3] = pv.w;
            }
            const float* cent = vcol + vb[t * p.rs + m_col] * dmv;
#pragma unroll
            for (int j = 0; j < SW; ++j) {
              if (j < live) {
                const float cv = cent[j];
#pragma unroll
                for (int g = 0; g < G; ++g) acc[g][j] = fmaf(pg[g], cv, acc[g][j]);
              }
            }
          }
        }
      } else {
        const __nv_bfloat16* vo =
            reinterpret_cast<const __nv_bfloat16*>(buf ? vo_tile[1] : vo_tile[0]) + (col - nsub);
#pragma unroll 4
        for (int t = grp; t < nt; t += ngrp) {
          const float v = __bfloat162float(vo[t * OV]);
#pragma unroll
          for (int j = 0; j < GQ; ++j) {
            const float4 pv = p4[t * GQ + j];
            const float pg[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (4 * j + k < G) acc[4 * j + k][0] = fmaf(pg[k], v, acc[4 * j + k][0]);
          }
        }
      }
    }
    __syncthreads();  // p_s and this buffer are rewritten next tile
  }

  // sum the thread groups in a fixed order, so that a launch gives the same
  // bits on every run: each group stores its accumulators to its own slab,
  // slab[grp][g][W] with the d dims then the OV exact channels (every entry
  // has one writer), and after one barrier each (g, dim) is summed over the
  // slabs in group order. Then place the outlier channels and normalise.
  const int W = d + OV;
  if (col_ok) {
    float* mine = slab + (long)grp * G * W;
    if (col < nsub) {
      const int j0 = sl * SW;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < SW; ++j)
          if (j0 + j < dmv) mine[g * W + m_col + (j0 + j) * Mv] = acc[g][j];
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) mine[g * W + d + col - nsub] = acc[g][0];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * W; i += THREADS) {
    float s = slab[i];
    for (int k = 1; k < ngrp; ++k) s += slab[(long)k * G * W + i];
    const int g = i / W, c = i - g * W;
    if (c < d) o_s[g * d + c] = s;
    else co_s[g * OV + c - d] = s;
  }
  __syncthreads();
  for (int i = tid; i < G * OV; i += THREADS) {
    const int g = i / OV, o = i % OV;
    o_s[g * d + p.voidx[o]] = co_s[i];
  }
  __syncthreads();
  for (int i = tid; i < G * d; i += THREADS) {
    const int g = i / d;
    float l = 1.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (gg == g) l = l_s[gg];
    p.out_part[base * G * d + i] = o_s[i] / l;
  }
  if (tid < G) {
    float lse = NEG_BIG;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g == tid) lse = m_s[g] + logf(l_s[g]);
    p.lse_part[base * G + tid] = lse;
  }
}

// LSE-merge of the per-split partials (merge_partials in ops/pq_attention_ref),
// together with the exact partial over the first r rows of the residual
// window when r > 0 (masked_partial_attention + merge_two_partials). One
// block of RTHREADS per (b, h); the residual rows are (bs, nh_k, Lt, d) of T
// (bf16 or f32). r is r_seq[b] (clamped to Lt) when r_seq is given, else the
// host's r. Every step spreads over the block, so the window's rows are read
// with coalesced loads, many in flight: the scores a warp per row (its lanes
// across the dims, a warp sum per query row), the softmax a warp per query
// row, P V a thread per (dim, group of rows) summed in shared memory, then
// the merge a thread per (query row, dim).
#define RTHREADS 512
#define MAX_G 8

__device__ __forceinline__ float res_f32(float v) { return v; }
__device__ __forceinline__ float res_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// shared memory of the reduce pass, in floats
static size_t reduce_smem_floats(int G, int d, int Lt) {
  const int groups = RTHREADS / d > 0 ? RTHREADS / d : 1;
  return (size_t)G * d + (size_t)G * Lt + 2 * G + (size_t)groups * G * d;
}

template <typename T>
__global__ void __launch_bounds__(RTHREADS) pq_reduce_kernel(const float* __restrict__ out_part,
                                                             const float* __restrict__ lse_part,
                                                             const float* __restrict__ q, const T* kres,
                                                             const T* vres, int r, const int* __restrict__ r_seq,
                                                             int nh_k, int Lt, float* __restrict__ out,
                                                             float* __restrict__ lse, int S, int G, int d) {
  extern __shared__ float rsm[];
  const int groups = RTHREADS / d > 0 ? RTHREADS / d : 1;  // groups of rows in P V
  float* q_s = rsm;             // G * d
  float* p_s = q_s + G * d;     // G * Lt: residual scores, then weights
  float* st = p_s + G * Lt;     // G * 2: residual max and sum
  float* o_s = st + 2 * G;      // groups * G * d: P V per group of rows
  const long bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = RTHREADS / 32;
  if (r_seq) r = max(0, min(r_seq[bh / nh_k], Lt));
  for (int i = tid; i < G * d; i += RTHREADS) q_s[i] = q[bh * G * d + i];
  __syncthreads();
  for (int j = warp; j < r; j += NW) {
    const T* kr = kres + (bh * Lt + j) * d;
    float acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float kv = res_f32(kr[k]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] = fmaf(q_s[g * d + k], kv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) {
        const float v = warp_sum(acc[g]);
        if (lane == 0) p_s[g * Lt + j] = v;
      }
  }
  __syncthreads();
  for (int g = warp; g < G; g += NW) {
    float m = -INFINITY, l = 0.f;
    for (int j = lane; j < r; j += 32) m = fmaxf(m, p_s[g * Lt + j]);
    m = warp_max(m);
    for (int j = lane; j < r; j += 32) {
      const float e = expf(p_s[g * Lt + j] - m);
      p_s[g * Lt + j] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      st[2 * g] = r > 0 ? m : NEG_BIG;
      st[2 * g + 1] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < groups * d; i += RTHREADS) {
    const int k = i % d, grp = i / d;
    float acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int j = grp; j < r; j += groups) {
      const float v = res_f32(vres[(bh * Lt + j) * d + k]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] = fmaf(p_s[g * Lt + j], v, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) o_s[(grp * G + g) * d + k] = acc[g];
  }
  __syncthreads();
  for (int i = tid; i < G * d; i += RTHREADS) {
    const int g = i / d, k = i % d;
    float o_r = 0.f, lse_r = NEG_BIG;
    if (r > 0) {
      for (int grp = 0; grp < groups; ++grp) o_r += o_s[(grp * G + g) * d + k];
      o_r /= st[2 * g + 1];
      lse_r = st[2 * g] + logf(st[2 * g + 1]);
    }
    float mx = lse_r;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, lse_part[(bh * S + s) * G + g]);
    float den = expf(lse_r - mx);
    float num = den * o_r;
    for (int s = 0; s < S; ++s) {
      const float w = expf(lse_part[(bh * S + s) * G + g] - mx);
      den += w;
      num += w * out_part[((bh * S + s) * G + g) * d + k];
    }
    out[bh * G * d + i] = num / den;
    if (k == 0) lse[bh * G + g] = mx + logf(den);
  }
}

static size_t up16(size_t n) { return (n + 15) / 16 * 16; }

template <typename K>
static cudaError_t launch(K kernel, const Params& p, int bs, size_t smem, size_t& attr_set,
                          cudaStream_t st) {
  if (smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = smem;
  }
  kernel<<<dim3(p.S, p.nh_k, bs), THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// Shared memory of a pass: its tiles and scalars (`need`), plus the pass's
// codebook when it fits beside them (else the codebook is read through L1).
static size_t with_cent(Params& p, size_t need, size_t cent_bytes, int optin) {
  p.cent_in_smem = need + cent_bytes <= (size_t)optin;
  return p.cent_in_smem ? need + cent_bytes : need;
}

// One launch of a pass's instantiation, each with its own record of the
// shared memory its attribute allows. The score pass's build (p.kwide) and
// the value pass's (p.vwide: DM 16, else 8) are the caller's choice: the
// wrapper's route (decode_route in ops/pq_attention_kernel.py) decides them
// for the geometry.
template <int G, bool WIDE, bool PAGED>
static cudaError_t launch_score_build(const Params& p, int bs, size_t smem, cudaStream_t st) {
  static size_t attr_set = 0;
  return launch(pq_score_kernel<G, WIDE, PAGED>, p, bs, smem, attr_set, st);
}

template <int G, int DM, bool PAGED>
static cudaError_t launch_value_build(const Params& p, int bs, size_t smem, cudaStream_t st) {
  static size_t attr_set = 0;
  return launch(pq_value_kernel<G, DM, PAGED>, p, bs, smem, attr_set, st);
}

template <int G, bool PAGED>
static cudaError_t launch_score(const Params& p, int bs, size_t smem, cudaStream_t st) {
  return p.kwide ? launch_score_build<G, true, PAGED>(p, bs, smem, st)
                 : launch_score_build<G, false, PAGED>(p, bs, smem, st);
}

template <int G, bool PAGED>
static cudaError_t launch_value(const Params& p, int bs, size_t smem, cudaStream_t st) {
  return p.vwide ? launch_value_build<G, 16, PAGED>(p, bs, smem, st)
                 : launch_value_build<G, 8, PAGED>(p, bs, smem, st);
}

template <int G, bool PAGED>
static cudaError_t launch_passes(const Params& p, int bs, int optin, cudaStream_t st) {
  constexpr int GP = 4 * ((G + 3) / 4);
  const int d = p.d;
  Params ps = p;
  ps.rs = code_row_stride(p.M);
  const size_t need_s = 2 * TILE * (size_t)ps.rs + 2 * (size_t)outlier_slot(p.OK) +
                        (size_t)d * GP * 4 + (size_t)(p.OK > 0 ? p.OK : 1) * GP * 4 +
                        up16(4 * (size_t)G * (THREADS / 32));
  if (need_s > (size_t)optin) return cudaErrorInvalidConfiguration;
  const size_t smem_s = with_cent(ps, need_s, sizeof(float) * (size_t)p.Ck * d, optin);
  cudaError_t e = launch_score<G, PAGED>(ps, bs, smem_s, st);
  if (e != cudaSuccess) return e;
  // the value pass: its sums, then the codebook (when it fits) and the
  // tiles, which the thread groups' slabs overwrite after the last tile
  Params pv = p;
  pv.rs = code_row_stride(p.Mv);
  const size_t head = up16(4 * (size_t)G * d) + up16(4 * (size_t)G * (p.OV > 0 ? p.OV : 1));
  const size_t tiles = 2 * TILE * (size_t)pv.rs + 2 * (size_t)outlier_slot(p.OV) +
                       up16(2 * TILE * 4 * (size_t)G) + (size_t)TILE * GP * 4;
  const size_t slab = sizeof(float) * (size_t)G * (d + p.OV) *
                      value_groups(p.vwide ? 16 : 8, G, p.Mv, p.dmv, p.OV);
  const size_t cent_v = sizeof(float) * (size_t)p.Cv * d;
  if (head + std::max(tiles, slab) > (size_t)optin) return cudaErrorInvalidConfiguration;
  pv.cent_in_smem = head + std::max(cent_v + tiles, slab) <= (size_t)optin;
  const size_t smem_v = head + std::max(pv.cent_in_smem ? cent_v + tiles : tiles, slab);
  return launch_value<G, PAGED>(pv, bs, smem_v, st);
}

// The reduce pass over residual rows of T (its shared memory may pass 48 KB
// for long windows).
template <typename T>
static cudaError_t launch_reduce(const Params& p, int bs, int G, const void* kres, const void* vres, int r,
                                 const int* r_seq, int Lt, float* out, float* lse, cudaStream_t st) {
  static size_t attr_set = 0;
  const size_t smem = sizeof(float) * reduce_smem_floats(G, p.d, Lt);
  auto kernel = pq_reduce_kernel<T>;
  if (smem > 48 * 1024 && smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = smem;
  }
  kernel<<<bs * p.nh_k, RTHREADS, smem, st>>>(p.out_part, p.lse_part, p.q, (const T*)kres, (const T*)vres, r,
                                              r_seq, p.nh_k, Lt, out, lse, p.S, G, p.d);
  return cudaGetLastError();
}

// The score and value passes for a GQA group of G rows (1..8), then the
// reduce pass. r_seq null: every sequence has r residual rows.
template <bool PAGED>
static int run_passes(const Params& p, int bs, int G, const void* kres, const void* vres, int r,
                      const int* r_seq, int Lt, int res_bf16, float* out, float* lse,
                      cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaError_t e;
  switch (G) {
    case 1: e = launch_passes<1, PAGED>(p, bs, optin, st); break;
    case 2: e = launch_passes<2, PAGED>(p, bs, optin, st); break;
    case 3: e = launch_passes<3, PAGED>(p, bs, optin, st); break;
    case 4: e = launch_passes<4, PAGED>(p, bs, optin, st); break;
    case 5: e = launch_passes<5, PAGED>(p, bs, optin, st); break;
    case 6: e = launch_passes<6, PAGED>(p, bs, optin, st); break;
    case 7: e = launch_passes<7, PAGED>(p, bs, optin, st); break;
    case 8: e = launch_passes<8, PAGED>(p, bs, optin, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  e = res_bf16 ? launch_reduce<__nv_bfloat16>(p, bs, G, kres, vres, r, r_seq, Lt, out, lse, st)
               : launch_reduce<float>(p, bs, G, kres, vres, r, r_seq, Lt, out, lse, st);
  return (int)e;
}
