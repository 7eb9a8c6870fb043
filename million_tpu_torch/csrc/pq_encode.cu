// Fused PQ encode: nearest centroid per (bank, token, subspace), one byte out.
//
// Replaces the TPU kernel million_tpu/ops/pq_encode_pallas.py::
// pq_encode_fused_stacked (_encode_kernel) and, with one bank,
// pq_encode_fused.
//
// What it computes, for bank s, token row r and subspace m:
//   code[s, r, m] = argmax_c  <x[s, r, dims(m)], cent[s, m, c]> - 0.5 ||cent[s, m, c]||^2
// which is the nearest centroid in squared L2; ties go to the lowest index.
// dims(m) is {m, m + M, ...} for the strided subspace split and
// [m d_m, (m + 1) d_m) for the contiguous one. "fast" rounds x and the
// centroids to bf16 and sums in f32, with ||c||^2 from the rounded centroids;
// "exact" keeps f32. The (rows, M, C) scores never leave the registers.
//
// The TPU kernel's augmented matmul (contraction padded to 8, ||c||^2 split
// into bf16 hi/lo slots) exists for the MXU and is not carried over: at
// d_m 1-8 this is CUDA-core work.
//
// Design. A block owns a tile of TB = 256 token rows and a group of
// MG = 32 / d_m neighbouring subspaces. It copies the group's codebooks
// (MG x C x d_m f32, at most 32 KB at C = 256) and their 0.5 ||c||^2 into
// shared memory, and the tile's x values for the group's dims, transposed so
// that lanes hold neighbouring tokens. The dims of neighbouring subspaces are
// neighbours in memory in both layouts, so the x reads are runs of MG (or
// MG d_m) elements. A warp takes one subspace at a time; each lane scans the
// C centroids for 8 tokens held in registers: per centroid one broadcast
// shared-memory read feeds 8 x (d_m FMAs, a compare, two selects). Codes are
// gathered in shared memory and written token-major (..., M), MG bytes per
// token, so they land in the arena without a transpose. x may be any strided
// view whose last dim is dense (the model's (bs, heads, n, d) transpose).
//
// Bound. rows x M x C x (2 d_m + 1) operations against 67 TFLOP/s f32, and
// (x + codes) bytes against 3.35 TB/s: at 1.024 M rows of d = 128 bf16 that
// is 1.25 ms (dm2, C = 256) or 0.56 ms (dm4, C = 128) by operations and
// 0.10 ms by bytes. The compare and the selects are not FMAs, so the kernel's
// own ceiling is about 5 instruction slots per centroid and token, 2-3x the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TB 256        // token rows per block
#define THREADS 256
#define NW (THREADS / 32)
#define T (TB / 32)   // tokens per lane
#define XLD (TB + 1)  // padded row of the transposed x tile

struct EncParams {
  const void* x;       // bf16 or f32, element strides below
  const float* cents;  // (S, M, C, DM) f32
  uint8_t* codes;      // (S, R, M) uint8
  long R;              // rows per bank = n0 * n1 * n2
  long n1, n2;         // inner row dims (row = (i0 * n1 + i1) * n2 + i2)
  long sS, s0, s1, s2; // element strides of x: bank, i0, i1, i2
  int M, C, MG;
  int x_bf16, strided, fast;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int DM>
__global__ void __launch_bounds__(THREADS) pq_encode_kernel(EncParams p) {
  extern __shared__ float smem[];
  const int M = p.M, C = p.C, MG = p.MG;
  float* cent_s = smem;                       // MG * C * DM
  float* hcsq_s = cent_s + MG * C * DM;       // MG * C
  float* x_s = hcsq_s + MG * C;               // MG * DM * XLD
  uint8_t* code_s = reinterpret_cast<uint8_t*>(x_s + MG * DM * XLD);  // TB * MG

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row0 = (long)blockIdx.x * TB;
  const int m0 = blockIdx.y * MG;
  const int s = blockIdx.z;
  const int mg = min(MG, M - m0);  // subspaces of this group

  // codebooks of the group, and 0.5 ||c||^2 from the values as they are used
  const float* cg = p.cents + ((long)s * M + m0) * C * DM;
  for (int i = tid; i < mg * C * DM; i += THREADS) {
    const float v = cg[i];
    cent_s[i] = p.fast ? round_bf16(v) : v;
  }
  __syncthreads();
  for (int i = tid; i < mg * C; i += THREADS) {
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < DM; ++j) {
      const float v = cent_s[i * DM + j];
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
    hcsq_s[i] = 0.5f * sq;
  }

  // x tile, transposed: x_s[(ml * DM + j) * XLD + token]
  const int per_row = MG * DM;
  for (int e = tid; e < TB * per_row; e += THREADS) {
    const int t = e / per_row, rem = e - t * per_row;
    int ml, j;
    if (p.strided) { j = rem / MG; ml = rem - j * MG; }
    else { ml = rem / DM; j = rem - ml * DM; }
    const long r = row0 + t;
    float v = 0.f;
    if (r < p.R && ml < mg) {
      const long i2 = r % p.n2, q = r / p.n2;
      const long i1 = q % p.n1, i0 = q / p.n1;
      const int dim = p.strided ? (m0 + ml + j * M) : ((m0 + ml) * DM + j);
      const long off = (long)s * p.sS + i0 * p.s0 + i1 * p.s1 + i2 * p.s2 + dim;
      if (p.x_bf16) {
        v = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.x)[off]);
      } else {
        v = reinterpret_cast<const float*>(p.x)[off];
        if (p.fast) v = round_bf16(v);
      }
    }
    x_s[(ml * DM + j) * XLD + t] = v;
  }
  __syncthreads();

  for (int ml = warp; ml < mg; ml += NW) {
    float xv[T][DM], best[T];
    int bi[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int j = 0; j < DM; ++j) xv[t][j] = x_s[(ml * DM + j) * XLD + lane + 32 * t];
      best[t] = -INFINITY;
      bi[t] = 0;
    }
    const float* cm = cent_s + ml * C * DM;
    const float* hm = hcsq_s + ml * C;
#pragma unroll 2
    for (int c = 0; c < C; ++c) {
      float cv[DM];
#pragma unroll
      for (int j = 0; j < DM; ++j) cv[j] = cm[c * DM + j];
      const float h = -hm[c];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float sc = h;
#pragma unroll
        for (int j = 0; j < DM; ++j) sc = fmaf(xv[t][j], cv[j], sc);
        if (sc > best[t]) {  // strict: the lowest index wins a tie
          best[t] = sc;
          bi[t] = c;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) code_s[(lane + 32 * t) * MG + ml] = (uint8_t)bi[t];
  }
  __syncthreads();

  uint8_t* out = p.codes + (long)s * p.R * M;
  for (int e = tid; e < TB * mg; e += THREADS) {
    const int t = e / mg, ml = e - t * mg;
    const long r = row0 + t;
    if (r < p.R) out[r * M + m0 + ml] = code_s[t * MG + ml];
  }
}

template <int DM>
static cudaError_t launch(const EncParams& p, int S, cudaStream_t st) {
  static size_t attr_set = 0;
  const size_t smem = sizeof(float) * ((size_t)p.MG * p.C * DM + (size_t)p.MG * p.C +
                                       (size_t)p.MG * DM * XLD) + (size_t)TB * p.MG;
  if (smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(pq_encode_kernel<DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = smem;
  }
  const dim3 grid((unsigned)((p.R + TB - 1) / TB), (unsigned)((p.M + p.MG - 1) / p.MG), (unsigned)S);
  pq_encode_kernel<DM><<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

extern "C" int pq_encode_tile() { return TB; }

// x: S banks of n0 * n1 * n2 rows of d = M * d_m elements (bf16 when x_bf16,
// else f32) at element strides (sS, s0, s1, s2), last dim dense. cents
// (S, M, C, d_m) f32 contiguous; codes (S, n0 * n1 * n2, M) uint8 contiguous.
// Returns a cudaError_t (0 on success); the caller validates shapes and types.
extern "C" int pq_encode(const void* x, const void* cents, void* codes, int S, long n0, long n1,
                         long n2, long sS, long s0, long s1, long s2, int M, int C, int d_m,
                         int x_bf16, int strided, int fast, void* stream) {
  EncParams p;
  p.x = x;
  p.cents = (const float*)cents;
  p.codes = (uint8_t*)codes;
  p.R = n0 * n1 * n2;
  p.n1 = n1; p.n2 = n2;
  p.sS = sS; p.s0 = s0; p.s1 = s1; p.s2 = s2;
  p.M = M; p.C = C; p.MG = 32 / d_m;
  p.x_bf16 = x_bf16; p.strided = strided; p.fast = fast;
  if (p.R <= 0 || S <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d_m) {
    case 1: return (int)launch<1>(p, S, st);
    case 2: return (int)launch<2>(p, S, st);
    case 4: return (int)launch<4>(p, S, st);
    case 8: return (int)launch<8>(p, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
