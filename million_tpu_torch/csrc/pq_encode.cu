// Fused PQ encode: nearest centroid per (bank, token, subspace), one byte out
// (two, int16, for codebooks wider than 256: the wide build further down).
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
// d_m 1-16 this is CUDA-core work, and the scores are the same f32 sums
// (-0.5 ||c||^2 + x_0 c_0 + ... as a chain of FMAs) in every version.
//
// Bound. rows x M x C x (2 d_m + 1) operations against the peak of their
// type, and (x + codes) bytes against 3.35 TB/s. "fast" multiplies bf16
// operands, whose products are exact in its f32 sums: bf16 tensor-core work,
// 989 TFLOP/s; "exact" is f32 work, 67 TFLOP/s. At 1.024 M rows of d = 128
// bf16, "fast", bytes bind: 0.098 ms (dm2, C = 256; 0.085 ms by operations),
// 0.088 ms (dm4, C = 128). This kernel runs on the CUDA cores (the k = d_m
// contraction is shorter than an MMA's), where what the SM can issue sets its
// own floor: per (token, subspace, centroid) d_m FMAs on the FMA pipe and
// whatever the argmax costs on the ALU pipe, which runs at half the FMA pipe's
// rate. With
// the design below a tile of 16 centroids x 8 tokens is ~430 instructions at
// d_m = 2 (256 FFMA, 144 on the ALU pipe, 24 loads), an issue floor of 1.68
// ms at the prefill shape (0.71 ms at d_m = 4, C = 128); the scan alone runs
// at about three quarters of it (benchmarks/encode_kernel_ab.py knock-outs).
//
// Design. The tiled kernel below is built for d_m in {1, 2, 4, 8, 16}; every
// other width (32, 64, 128, and widths that are not powers of two) takes the
// generic kernel further down, which the wrapper's route picks.
// - Max first, locate once. A lane holds T tokens of one subspace and scans
//   the centroids in tiles of CT: per tile and token it computes CT scores,
//   takes their max with a tree of FMNMX, and keeps the running best and
//   the first tile whose max beat it (a compare and a select per tile, not
//   per centroid): about 1 + 3 / CT ALU operations per centroid and token
//   instead of a compare and two selects. After the scan it recomputes the
//   winning tile's scores (the same FMA chain, so the same bits) and takes
//   the lowest index that reaches the best. This is the TPU kernel's rule
//   (the max, then the lowest index reaching it), a tile at a time. A tile
//   is CT centroids' values and their -0.5 ||c||^2 side by side, read with
//   8-byte loads: broadcast in the scan, one tile per lane in the locate,
//   where the tiles' padding keeps the banks apart.
// - Persistent blocks. The grid is sized to the card (blocks per SM from the
//   occupancy query x SMs); the work items (bank, group of MG = 32 / d_m
//   subspaces, tile of TB rows) are split into equal contiguous runs, one per
//   block, so a block stages a group's codebooks and their -0.5 ||c||^2
//   once per run (once or twice), not once per tile. The host picks a tile
//   of 256 or 128 rows, whichever leaves the fuller last wave (the 24,576
//   rows of a serving admission chunk take 128).
// - Staging without division per element. A thread splits each of its rows
//   into (i0, i1, i2) once (32-bit), then copies the row's group in 16-byte
//   pieces (8-byte for bf16 at d_m = 8): a group's dims are runs of MG
//   elements (strided) or one run of 32 (contiguous). The tile is stored
//   transposed in shared memory so that lanes read neighbouring tokens. Odd
//   strides, bases or geometries take an element-wise copy instead.
// - Codes are gathered in shared memory and written token-major (..., M), a
//   row's MG bytes in one vector store, so they land in the arena without a
//   transpose. x may be any strided view whose last dim is dense (the
//   model's (bs, heads, n, d) transpose).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#define TB_MAX 256    // the larger row tile (pq_encode_tile)
#define THREADS 256
#define NW (THREADS / 32)
#define GROUP_DIMS 32  // dims of a row one block stages: MG = GROUP_DIMS / d_m subspaces
#define SMALL_TILE_GAIN 0.9  // take 128-row tiles only where they cut the estimate by 10 %

struct EncParams {
  const void* x;       // bf16 or f32, element strides below
  const float* cents;  // (S, M, C, DM) f32
  uint8_t* codes;      // (S, R, M) uint8
  long R;              // rows per bank = n0 * n1 * n2 (< 2^31)
  unsigned n1, n2;     // inner row dims (row = (i0 * n1 + i1) * n2 + i2)
  long sS, s0, s1, s2; // element strides of x: bank, i0, i1, i2
  int M, C, Cp, G;     // Cp: C padded to the centroid tile; G: groups of MG subspaces
  int x_bf16, strided, fast;
  int vec_x;           // x in 16-byte (8-byte) pieces: aligned base and strides, M % MG == 0
  int vec_codes;       // a row's MG codes in one store: M % MG == 0
  long ntiles, items;  // row tiles per bank; items = S * G * ntiles
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// centroids per scan tile: d_m FMAs + ~1 + 3 / CT ALU operations per centroid and token (at
// d_m = 16 a tile of 2 keeps the scan's tile and tokens in registers)
__host__ __device__ constexpr int ctile(int dm) { return dm <= 2 ? 16 : (dm == 4 ? 8 : (dm == 8 ? 4 : 2)); }
// floats of a centroid tile in shared memory: CT centroids, then their -0.5 ||c||^2, padded to
// an odd number of 8-byte pairs, so that up to 16 tiles start in 16 different bank pairs: the
// locate step, where each lane reads the tile its token won, then loads without conflicts
__host__ __device__ constexpr int tile_floats(int dm) {
  return 2 * ((ctile(dm) * (dm + 1) + 1) / 2 + (((ctile(dm) * (dm + 1) + 1) / 2) % 2 == 0));
}
// token slices of a tile: every warp gets a (subspace, slice) unit even where MG < NW
__host__ __device__ constexpr int slices(int dm) { return (GROUP_DIMS / dm) >= NW ? 1 : NW / (GROUP_DIMS / dm); }

// padded row of the transposed x tile
__host__ __device__ constexpr int xld(int tb) { return tb + 1; }
// elements of x one staging load moves: 16 bytes, or a strided group's run of MG = 32 / d_m
// consecutive dims where that is shorter (bf16 at d_m = 8, both types at d_m = 16)
__host__ __device__ constexpr int piece(int dm, bool xbf16) {
  return (xbf16 ? 8 : 4) < GROUP_DIMS / dm ? (xbf16 ? 8 : 4) : GROUP_DIMS / dm;
}

template <int DM, int TB>
static size_t smem_bytes(int Cp) {
  const int MG = GROUP_DIMS / DM;
  return sizeof(float) * ((size_t)MG * (Cp / ctile(DM)) * tile_floats(DM)
                          + (size_t)GROUP_DIMS * xld(TB)) + (size_t)TB * MG;
}

__device__ __forceinline__ long row_offset(const EncParams& p, int s, unsigned r) {
  const unsigned q = r / p.n2, i2 = r - q * p.n2;
  const unsigned i0 = q / p.n1, i1 = q - i0 * p.n1;
  return (long)s * p.sS + (long)i0 * p.s0 + (long)i1 * p.s1 + (long)i2 * p.s2;
}

// Shared-memory float offset of centroid c's tile for subspace ml: cs holds, per subspace,
// Cp / CT tiles of tile_floats(DM) floats (CT x DM centroid values, then CT of -0.5 ||c||^2).
template <int DM>
__device__ __forceinline__ int tile_base(int ml, int c, int Cp) {
  return (ml * (Cp / ctile(DM)) + c / ctile(DM)) * tile_floats(DM);
}

// The group's codebooks, padded to Cp centroids, into the tiles of cs.
template <int DM>
__device__ void stage_codebooks(const EncParams& p, int s, int m0, int mg, float* cs) {
  constexpr int CT = ctile(DM);
  const float* src = p.cents + ((long)s * p.M + m0) * p.C * DM;
  const int n = (GROUP_DIMS / DM) * p.Cp * DM;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int j = i % DM, mc = i / DM, ml = mc / p.Cp, c = mc - ml * p.Cp;
    float v = 0.f;
    if (ml < mg && c < p.C) {
      v = src[((long)ml * p.C + c) * DM + j];
      if (p.fast) v = round_bf16(v);
    }
    cs[tile_base<DM>(ml, c, p.Cp) + (c % CT) * DM + j] = v;
  }
}

// -0.5 ||c||^2 from the values as they are used; -inf for the padding, which never wins
template <int DM>
__device__ void half_norms(const EncParams& p, int mg, float* cs) {
  constexpr int CT = ctile(DM);
  const int n = (GROUP_DIMS / DM) * p.Cp;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int ml = i / p.Cp, c = i - ml * p.Cp;
    float* tile = cs + tile_base<DM>(ml, c, p.Cp);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < DM; ++j) {
      const float v = tile[(c % CT) * DM + j];
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
    tile[CT * DM + c % CT] = (ml < mg && c < p.C) ? -(0.5f * sq) : -INFINITY;
  }
}

// The tile's x for the group's dims, transposed: xs[(ml * DM + j) * XLD + t].
template <int DM, int TB, bool XBF16>
__device__ void stage_x_vec(const EncParams& p, int s, int m0, long row0, float* xs) {
  constexpr int MG = GROUP_DIMS / DM, XLD = xld(TB);
  constexpr int W = piece(DM, XBF16);
  constexpr int NQ = GROUP_DIMS / W, RS = THREADS / NQ, KR = TB / RS;
  using Piece = typename std::conditional<
      XBF16, typename std::conditional<W == 8, uint4, typename std::conditional<W == 4, uint2, unsigned>::type>::type,
      typename std::conditional<W == 4, float4, float2>::type>::type;
  const int q = threadIdx.x % NQ, t0 = threadIdx.x / NQ, e0 = q * W;
  const int dim = p.strided ? (m0 + e0 % MG + (e0 / MG) * p.M) : (m0 * DM + e0);
  Piece buf[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const long r = row0 + t0 + k * RS;
    if (r < p.R) {
      const long off = row_offset(p, s, (unsigned)r) + dim;
      buf[k] = *reinterpret_cast<const Piece*>(
          static_cast<const char*>(p.x) + off * (XBF16 ? 2 : 4));
    } else {
      buf[k] = Piece{};
    }
  }
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    float v[W];
    if constexpr (XBF16) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&buf[k]);
#pragma unroll
      for (int w = 0; w < W / 2; ++w) {
        const float2 f = __bfloat1622float2(h[w]);
        v[2 * w] = f.x;
        v[2 * w + 1] = f.y;
      }
    } else {
      if constexpr (W == 4) {
        v[0] = buf[k].x; v[1] = buf[k].y; v[2] = buf[k].z; v[3] = buf[k].w;
      } else {
        v[0] = buf[k].x; v[1] = buf[k].y;
      }
      if (p.fast) {
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = round_bf16(v[w]);
      }
    }
    const int t = t0 + k * RS;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int e = e0 + w;
      const int xrow = p.strided ? ((e % MG) * DM + e / MG) : e;  // ml * DM + j
      xs[xrow * XLD + t] = v[w];
    }
  }
}

// Element-wise copy for odd strides, bases and partial groups.
template <int DM, int TB>
__device__ void stage_x_scalar(const EncParams& p, int s, int m0, int mg, long row0, float* xs) {
  constexpr int MG = GROUP_DIMS / DM, XLD = xld(TB);
  for (int i = threadIdx.x; i < TB * GROUP_DIMS; i += THREADS) {
    const int t = i / GROUP_DIMS, e = i % GROUP_DIMS;
    const int ml = p.strided ? e % MG : e / DM, j = p.strided ? e / MG : e % DM;
    const long r = row0 + t;
    float v = 0.f;
    if (r < p.R && ml < mg) {
      const int dim = p.strided ? (m0 + ml + j * p.M) : ((m0 + ml) * DM + j);
      const long off = row_offset(p, s, (unsigned)r) + dim;
      if (p.x_bf16) {
        v = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.x)[off]);
      } else {
        v = reinterpret_cast<const float*>(p.x)[off];
        if (p.fast) v = round_bf16(v);
      }
    }
    xs[(ml * DM + j) * XLD + t] = v;
  }
}

// max over sc[0, 2W) into sc[0], a tree of FMNMX
template <int W, int CT>
__device__ __forceinline__ void fold_max(float (&sc)[CT]) {
#pragma unroll
  for (int i = 0; i < W; ++i) sc[i] = fmaxf(sc[i], sc[i + W]);
  if constexpr (W > 1) fold_max<W / 2, CT>(sc);
}

// A centroid tile (CT x DM values, CT of -0.5 ||c||^2) from shared memory into registers.
template <int DM>
__device__ __forceinline__ void load_tile(const float* tp, float (&cv)[ctile(DM) * DM],
                                          float (&nh)[ctile(DM)]) {
  constexpr int CT = ctile(DM);
  const float2* c2 = reinterpret_cast<const float2*>(tp);
#pragma unroll
  for (int i = 0; i < CT * DM / 2; ++i) {
    const float2 v = c2[i];
    cv[2 * i] = v.x; cv[2 * i + 1] = v.y;
  }
  const float2* h2 = reinterpret_cast<const float2*>(tp + CT * DM);
#pragma unroll
  for (int i = 0; i < CT / 2; ++i) {
    const float2 v = h2[i];
    nh[2 * i] = v.x; nh[2 * i + 1] = v.y;
  }
}

// One warp: subspace ml of the group (its tiles at cm), T tokens per lane from token tok0.
template <int DM, int T>
__device__ __forceinline__ void scan(const float* xs, int xld_, const float* cm, int n_tiles, int tok0,
                                     int lane, uint8_t* code_s, int MG, int ml) {
  constexpr int CT = ctile(DM), TS = tile_floats(DM);
  float xv[T][DM], best[T];
  int bt[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int j = 0; j < DM; ++j) xv[t][j] = xs[j * xld_ + tok0 + lane + 32 * t];
    best[t] = -INFINITY;
    bt[t] = 0;
  }
#pragma unroll 1
  for (int ti = 0; ti < n_tiles; ++ti) {
    float cv[CT * DM], nh[CT];
    load_tile<DM>(cm + ti * TS, cv, nh);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float sc[CT];
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        float a = nh[k];
#pragma unroll
        for (int j = 0; j < DM; ++j) a = fmaf(xv[t][j], cv[k * DM + j], a);
        sc[k] = a;
      }
      fold_max<CT / 2, CT>(sc);
      bt[t] = sc[0] > best[t] ? ti : bt[t];  // strict: the first tile reaching the best is kept
      best[t] = fmaxf(best[t], sc[0]);
    }
  }
  // the lowest index of the winning tile whose score (the same FMA chain) reaches the best
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float cv[CT * DM], nh[CT];
    load_tile<DM>(cm + bt[t] * TS, cv, nh);
    int idx = 0;
#pragma unroll
    for (int k = CT - 1; k >= 0; --k) {
      float a = nh[k];
#pragma unroll
      for (int j = 0; j < DM; ++j) a = fmaf(xv[t][j], cv[k * DM + j], a);
      idx = a == best[t] ? k : idx;
    }
    code_s[(tok0 + lane + 32 * t) * MG + ml] = (uint8_t)(bt[t] * CT + idx);
  }
}

template <int N>
__device__ __forceinline__ void copy_codes(uint8_t* dst, const uint8_t* src) {
  if constexpr (N >= 16) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  }
}

template <int DM, int TB>
__global__ void __launch_bounds__(THREADS, 2) pq_encode_kernel(EncParams p) {
  constexpr int MG = GROUP_DIMS / DM, NSL = slices(DM), T = TB / (32 * NSL), XLD = xld(TB);
  extern __shared__ __align__(16) float smem[];
  constexpr int CT = ctile(DM), TS = tile_floats(DM);
  const int n_tiles = p.Cp / CT;
  float* cs = smem;                      // MG * n_tiles * TS: the codebook tiles
  float* xs = cs + MG * n_tiles * TS;    // GROUP_DIMS * XLD
  uint8_t* code_s = reinterpret_cast<uint8_t*>(xs + GROUP_DIMS * XLD);  // TB * MG

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long it0 = (long)blockIdx.x * p.items / gridDim.x;
  const long it1 = (long)(blockIdx.x + 1) * p.items / gridDim.x;
  long staged = -1;  // (bank, group) whose codebooks are in shared memory
  for (long it = it0; it < it1; ++it) {
    const long sg = it / p.ntiles;
    const long row0 = (it - sg * p.ntiles) * TB;
    const int s = (int)(sg / p.G), g = (int)(sg - (long)s * p.G);
    const int m0 = g * MG, mg = min(MG, p.M - m0);
    __syncthreads();  // the previous item is done with the shared buffers
    if (sg != staged) {
      stage_codebooks<DM>(p, s, m0, mg, cs);
      __syncthreads();
      half_norms<DM>(p, mg, cs);
      staged = sg;
    }
    if (p.vec_x) {
      if (p.x_bf16) stage_x_vec<DM, TB, true>(p, s, m0, row0, xs);
      else stage_x_vec<DM, TB, false>(p, s, m0, row0, xs);
    } else {
      stage_x_scalar<DM, TB>(p, s, m0, mg, row0, xs);
    }
    __syncthreads();

    for (int u = warp; u < MG * NSL; u += NW) {
      const int ml = u % MG, tok0 = (u / MG) * 32 * T;
      if (ml < mg)
        scan<DM, T>(xs + ml * DM * XLD, XLD, cs + ml * n_tiles * TS, n_tiles, tok0, lane, code_s, MG, ml);
    }
    __syncthreads();

    uint8_t* out = p.codes + (long)s * p.R * p.M;
    if (p.vec_codes) {
      for (int t = tid; t < TB; t += THREADS) {
        const long r = row0 + t;
        if (r < p.R) copy_codes<MG>(out + r * p.M + m0, code_s + t * MG);
      }
    } else {
      for (int e = tid; e < TB * mg; e += THREADS) {
        const int t = e / mg, ml = e - t * mg;
        const long r = row0 + t;
        if (r < p.R) out[r * p.M + m0 + ml] = code_s[t * MG + ml];
      }
    }
  }
}

struct Plan {
  long items;
  int blocks;
  double cost;  // rows of the busiest block x blocks sharing its SM
};

// Blocks per SM for this instantiation at this shared-memory size (cached),
// after raising the kernel's dynamic shared-memory limit where needed.
template <int DM, int TB>
static cudaError_t plan(EncParams& p, int S, int n_sm, Plan* out) {
  static size_t attr_set = 0, occ_smem = 0;
  static int occ_blocks = 0;
  const size_t smem = smem_bytes<DM, TB>(p.Cp);
  if (smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(pq_encode_kernel<DM, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = smem;
  }
  if (smem != occ_smem) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, pq_encode_kernel<DM, TB>,
                                                                  THREADS, smem);
    if (e != cudaSuccess) return e;
    if (occ_blocks < 1) return cudaErrorInvalidConfiguration;
    occ_smem = smem;
  }
  const long items = (long)S * p.G * ((p.R + TB - 1) / TB);
  const long slots = (long)occ_blocks * n_sm;
  const long blocks = items < slots ? items : slots;
  const long per_block = (items + blocks - 1) / blocks;
  const long per_sm = (blocks + n_sm - 1) / n_sm;
  out->items = items;
  out->blocks = (int)blocks;
  out->cost = (double)per_block * TB * (per_sm < occ_blocks ? per_sm : occ_blocks);
  return cudaSuccess;
}

template <int DM, int TB>
static cudaError_t launch(EncParams p, const Plan& pl, cudaStream_t st) {
  p.ntiles = (p.R + TB - 1) / TB;
  p.items = pl.items;
  pq_encode_kernel<DM, TB><<<pl.blocks, THREADS, smem_bytes<DM, TB>(p.Cp), st>>>(p);
  return cudaGetLastError();
}

template <int DM>
static cudaError_t run(EncParams& p, int S, cudaStream_t st) {
  constexpr int MG = GROUP_DIMS / DM, CT = ctile(DM);
  p.G = (p.M + MG - 1) / MG;
  p.Cp = (p.C + CT - 1) / CT * CT;
  const int W = piece(DM, p.x_bf16);
  const int xbytes = p.x_bf16 ? 2 : 4;
  p.vec_codes = p.M % MG == 0;
  p.vec_x = p.vec_codes && (uintptr_t)p.x % (W * xbytes) == 0 && p.sS % W == 0 && p.s0 % W == 0
            && p.s1 % W == 0 && p.s2 % W == 0;
  int dev, n_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  Plan big, small;
  if (e == cudaSuccess) e = plan<DM, TB_MAX>(p, S, n_sm, &big);
  if (e == cudaSuccess) e = plan<DM, TB_MAX / 2>(p, S, n_sm, &small);
  if (e != cudaSuccess) return e;
  if (small.cost < SMALL_TILE_GAIN * big.cost) return launch<DM, TB_MAX / 2>(p, small, st);
  return launch<DM, TB_MAX>(p, big, st);
}

// The generic width: any d_m, for the geometries the tiled kernel is not
// built for (d_m 32, 64 and 128, where a group of 32 dims holds less than a
// subspace, and the widths that are not powers of two). A block owns one
// (bank, subspace) and walks row tiles of GT rows, a thread per row: the
// subspace's codebook sits in shared memory transposed (cs[j][c], with its
// -0.5 ||c||^2 beside it), the tile's x transposed (xs[j][t]), and a thread
// scores four centroids at a time with the same FMA chain as the tiled
// kernel (-0.5 ||c||^2, then x_0 c_0, x_1 c_1, ...), keeping the first
// centroid that beats the running best: the same codes, ties to the lowest
// index. Slow by design (two shared loads per four FMAs, a block per
// subspace); its time is in PERF.md.
#define GT 128  // rows per tile of the generic kernel

static size_t generic_smem(int Cp, int dm) {
  return sizeof(float) * ((size_t)Cp * dm + Cp + (size_t)dm * GT);
}

__global__ void __launch_bounds__(GT) pq_encode_generic_kernel(EncParams p, int dm) {
  extern __shared__ __align__(16) float gsm[];
  const int Cp = p.Cp;
  float* cs = gsm;              // dm * Cp: cs[j * Cp + c]
  float* nh = cs + dm * Cp;     // Cp
  float* xs = nh + Cp;          // dm * GT: xs[j * GT + t]
  const int m = blockIdx.y, s = blockIdx.z, t = threadIdx.x;
  const float* src = p.cents + ((long)s * p.M + m) * p.C * dm;
  for (int i = t; i < Cp * dm; i += GT) {
    const int c = i / dm, j = i - c * dm;
    float v = 0.f;
    if (c < p.C) {
      v = src[(long)c * dm + j];
      if (p.fast) v = round_bf16(v);
    }
    cs[j * Cp + c] = v;
  }
  __syncthreads();
  for (int c = t; c < Cp; c += GT) {
    float sq = 0.f;
    for (int j = 0; j < dm; ++j) {
      const float v = cs[j * Cp + c];
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
    nh[c] = c < p.C ? -(0.5f * sq) : -INFINITY;
  }
  uint8_t* out = p.codes + (long)s * p.R * p.M;
  for (long tile = blockIdx.x; tile * GT < p.R; tile += gridDim.x) {
    const long row0 = tile * GT;
    __syncthreads();  // nh is written, and the previous tile's x is read
    for (int i = t; i < GT * dm; i += GT) {
      const int tt = i / dm, j = i - tt * dm;
      const long r = row0 + tt;
      float v = 0.f;
      if (r < p.R) {
        const int dim = p.strided ? (m + j * p.M) : (m * dm + j);
        const long off = row_offset(p, s, (unsigned)r) + dim;
        if (p.x_bf16) {
          v = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.x)[off]);
        } else {
          v = reinterpret_cast<const float*>(p.x)[off];
          if (p.fast) v = round_bf16(v);
        }
      }
      xs[j * GT + tt] = v;
    }
    __syncthreads();
    float best = -INFINITY;
    int idx = 0;
    for (int c0 = 0; c0 < Cp; c0 += 4) {
      float a0 = nh[c0], a1 = nh[c0 + 1], a2 = nh[c0 + 2], a3 = nh[c0 + 3];
      for (int j = 0; j < dm; ++j) {
        const float xv = xs[j * GT + t];
        const float4 cv = *reinterpret_cast<const float4*>(cs + j * Cp + c0);
        a0 = fmaf(xv, cv.x, a0);
        a1 = fmaf(xv, cv.y, a1);
        a2 = fmaf(xv, cv.z, a2);
        a3 = fmaf(xv, cv.w, a3);
      }
      if (a0 > best) { best = a0; idx = c0; }
      if (a1 > best) { best = a1; idx = c0 + 1; }
      if (a2 > best) { best = a2; idx = c0 + 2; }
      if (a3 > best) { best = a3; idx = c0 + 3; }
    }
    const long r = row0 + t;
    if (r < p.R) out[r * p.M + m] = (uint8_t)idx;
  }
}

static cudaError_t run_generic(EncParams& p, int S, int dm, cudaStream_t st) {
  static size_t attr_set = 0;
  p.Cp = (p.C + 3) / 4 * 4;
  const size_t smem = generic_smem(p.Cp, dm);
  if (smem > 48 * 1024 && smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(pq_encode_generic_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = smem;
  }
  int dev, n_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long tiles = (p.R + GT - 1) / GT;
  const long per = (long)p.M * S;  // blocks a row tile spreads over
  long gx = (4L * n_sm + per - 1) / per;  // about four blocks per SM in all
  if (gx > tiles) gx = tiles;
  if (gx < 1) gx = 1;
  pq_encode_generic_kernel<<<dim3((unsigned)gx, (unsigned)p.M, (unsigned)S), GT, smem, st>>>(p, dm);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide codebooks: 256 < C <= 65,536 (fault C.10), int16 codes.
//
// The TPU kernel stages a group's whole (C, K) codebook per grid step and takes
// any C. The kernels above hold a group's (or a subspace's) whole codebook in
// shared memory, which at C = 4096 and d_m = 2 is 16 x 4096 x 3 x 4 B = 786 KB
// against the 227 KB a block may use. The wide build streams the codebook
// through shared memory instead:
// - A prepare pass writes each bank's codebooks once per launch into a scratch
//   buffer (the wrapper's, S x pq_encode_wide_scratch floats), already in the
//   form the scan reads: tiles of CT centroids (bf16-rounded for "fast") and
//   their -0.5 ||c||^2 (-inf for the padding up to a whole chunk), the same
//   values and sums as the narrow kernels compute in shared memory.
// - The tiled wide kernel (d_m in {1, 2, 4, 8, 16}) walks (bank, group of MG
//   subspaces, 128-row tile) items as the tiled kernel does, with the same x
//   staging and the same max-first scan, but over chunks of WCC centroids that
//   cp.async copies from the scratch into two shared buffers: chunk k + 1 is
//   in flight while chunk k is scanned. A lane keeps each token's running best
//   across chunks and the first tile (chunk x tiles + tile) that reached it;
//   after the last chunk it recomputes that tile from the scratch in global
//   memory (the same values, the same FMA chain, so the same bits) and takes
//   the lowest index that reaches the best. A layer's prepared codebook
//   (2 MB at d = 128, C = 4096) stays in L2 across the items that stream it.
// - Every other width takes the generic wide kernel: a block per (bank,
//   subspace) walking 128-row tiles, a thread per row, chunks of 64 centroids
//   in tiles of 4 streamed the same way, the first centroid that beats the
//   running best kept (ties to the lowest index).
// Codes are written token-major as int16: a code above 32,767 is its bit
// pattern, which the port reads back unsigned. Bound as above: at the
// prefill shape and C = 4096 operations bind, 1.36 ms at dm2 ("fast", bf16
// tensor cores), against 0.12 ms for the bytes (x and 2 B codes).
#define WTB 128   // rows per item of the tiled wide kernel
#define WCC 128   // centroids per streamed chunk (tiled wide kernel)
#define GCC 64    // centroids per streamed chunk (generic wide kernel)
#define GCT 4     // centroids per tile of the generic wide kernel

struct WideParams {
  EncParams e;         // e.codes unused; e.Cp = C padded to whole chunks
  uint16_t* codes;     // (S, R, M) int16 bit patterns
  const float* prep;   // S banks of prep_bank floats: per subspace NT tiles of TS floats
  long prep_bank;
  int NT, TS, nch;     // tiles per subspace, floats per tile, chunks per subspace
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The scratch form of every bank's codebooks: tile t of subspace m of bank s at
// prep + s * prep_bank + (m * NT + t) * TS, CT x dm values then CT of -0.5 ||c||^2.
__global__ void pq_encode_wide_prepare(const float* cents, float* prep, long banks_x_m, int C, int Cp,
                                       int dm, int CT, int TS, int fast) {
  const long n = banks_x_m * Cp;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    const long sm = i / Cp;
    const int c = (int)(i - sm * Cp);
    float* tile = prep + (sm * (Cp / CT) + c / CT) * TS;
    float sq = 0.f;
    for (int j = 0; j < dm; ++j) {
      float v = 0.f;
      if (c < C) {
        v = cents[(sm * C + c) * dm + j];
        if (fast) v = round_bf16(v);
      }
      tile[(c % CT) * dm + j] = v;
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
    tile[CT * dm + c % CT] = c < C ? -(0.5f * sq) : -INFINITY;
  }
}

// One unit's T tokens over the TPC tiles of a chunk (tile indices from t0): the
// scan of the tiled kernel, keeping the running best and its first tile.
template <int DM, int T>
__device__ __forceinline__ void scan_chunk(const float (&xv)[T][DM], float (&best)[T], int (&bt)[T],
                                           const float* cm, int tpc, int t0) {
  constexpr int CT = ctile(DM), TS = tile_floats(DM);
#pragma unroll 1
  for (int ti = 0; ti < tpc; ++ti) {
    float cv[CT * DM], nh[CT];
    load_tile<DM>(cm + ti * TS, cv, nh);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float sc[CT];
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        float a = nh[k];
#pragma unroll
        for (int j = 0; j < DM; ++j) a = fmaf(xv[t][j], cv[k * DM + j], a);
        sc[k] = a;
      }
      fold_max<CT / 2, CT>(sc);
      bt[t] = sc[0] > best[t] ? t0 + ti : bt[t];  // strict: the first tile reaching the best is kept
      best[t] = fmaxf(best[t], sc[0]);
    }
  }
}

template <int DM>
__global__ void __launch_bounds__(THREADS, 2) pq_encode_wide_kernel(WideParams w) {
  constexpr int MG = GROUP_DIMS / DM, NSL = slices(DM), T = WTB / (32 * NSL), XLD = xld(WTB);
  constexpr int CT = ctile(DM), TS = tile_floats(DM), TPC = WCC / CT, CH = TPC * TS;
  constexpr int U = (MG * NSL + NW - 1) / NW;  // units a warp owns
  static_assert(CH % 4 == 0, "a chunk must be whole 16-byte pieces");
  const EncParams& p = w.e;
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;                                  // 2 x MG x CH: the streamed chunks
  float* xs = buf + 2 * MG * CH;                      // GROUP_DIMS x XLD
  uint16_t* code_s = reinterpret_cast<uint16_t*>(xs + GROUP_DIMS * XLD);  // WTB x MG

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long it0 = (long)blockIdx.x * p.items / gridDim.x;
  const long it1 = (long)(blockIdx.x + 1) * p.items / gridDim.x;
  for (long it = it0; it < it1; ++it) {
    const long sg = it / p.ntiles;
    const long row0 = (it - sg * p.ntiles) * WTB;
    const int s = (int)(sg / p.G), g = (int)(sg - (long)s * p.G);
    const int m0 = g * MG, mg = min(MG, p.M - m0);
    const float* bank = w.prep + (long)s * w.prep_bank;
    auto issue = [&](int k) {  // chunk k of the group's subspaces into buffer k & 1
      float* dst = buf + (k & 1) * MG * CH;
      for (int i = tid; i < mg * (CH / 4); i += THREADS) {
        const int ml = i / (CH / 4), q = i - ml * (CH / 4);
        cp_async16(dst + ml * CH + 4 * q, bank + ((long)(m0 + ml) * w.NT + (long)k * TPC) * TS + 4 * q);
      }
      cp_async_commit();
    };
    __syncthreads();  // the previous item is done with the shared buffers
    issue(0);
    if (p.vec_x) {
      if (p.x_bf16) stage_x_vec<DM, WTB, true>(p, s, m0, row0, xs);
      else stage_x_vec<DM, WTB, false>(p, s, m0, row0, xs);
    } else {
      stage_x_scalar<DM, WTB>(p, s, m0, mg, row0, xs);
    }
    float xv[U][T][DM], best[U][T];
    int bt[U][T];
    for (int k = 0; k < w.nch; ++k) {
      cp_async_wait_all();
      __syncthreads();  // chunk k has landed, and every warp is done with chunk k - 1
      if (k == 0) {
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int u = warp + i * NW, ml = u % MG, tok0 = (u / MG) * 32 * T;
#pragma unroll
          for (int t = 0; t < T; ++t) {
#pragma unroll
            for (int j = 0; j < DM; ++j) xv[i][t][j] = u < MG * NSL ? xs[(ml * DM + j) * XLD + tok0 + lane + 32 * t] : 0.f;
            best[i][t] = -INFINITY;
            bt[i][t] = 0;
          }
        }
      }
      if (k + 1 < w.nch) issue(k + 1);
      const float* cb = buf + (k & 1) * MG * CH;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = warp + i * NW, ml = u % MG;
        if (u < MG * NSL && ml < mg) scan_chunk<DM, T>(xv[i], best[i], bt[i], cb + ml * CH, TPC, k * TPC);
      }
    }
    // the lowest index of each token's winning tile (read from the scratch) that reaches its best
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = warp + i * NW, ml = u % MG, tok0 = (u / MG) * 32 * T;
      if (u >= MG * NSL || ml >= mg) continue;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float cv[CT * DM], nh[CT];
        load_tile<DM>(bank + ((long)(m0 + ml) * w.NT + bt[i][t]) * TS, cv, nh);
        int idx = 0;
#pragma unroll
        for (int k = CT - 1; k >= 0; --k) {
          float a = nh[k];
#pragma unroll
          for (int j = 0; j < DM; ++j) a = fmaf(xv[i][t][j], cv[k * DM + j], a);
          idx = a == best[i][t] ? k : idx;
        }
        code_s[(tok0 + lane + 32 * t) * MG + ml] = (uint16_t)(bt[i][t] * CT + idx);
      }
    }
    __syncthreads();
    uint16_t* out = w.codes + (long)s * p.R * p.M;
    if (p.vec_codes) {
      for (int t = tid; t < WTB; t += THREADS) {
        const long r = row0 + t;
        if (r < p.R)
          copy_codes<2 * MG>(reinterpret_cast<uint8_t*>(out + r * p.M + m0),
                             reinterpret_cast<const uint8_t*>(code_s + t * MG));
      }
    } else {
      for (int e = tid; e < WTB * mg; e += THREADS) {
        const int t = e / mg, ml = e - t * mg;
        const long r = row0 + t;
        if (r < p.R) out[r * p.M + m0 + ml] = code_s[t * MG + ml];
      }
    }
  }
}

template <int DM>
static size_t wide_smem() {
  constexpr int MG = GROUP_DIMS / DM, CH = (WCC / ctile(DM)) * tile_floats(DM);
  return sizeof(float) * ((size_t)2 * MG * CH + (size_t)GROUP_DIMS * xld(WTB)) + sizeof(uint16_t) * WTB * MG;
}

template <int DM>
static cudaError_t run_wide(WideParams& w, int S, cudaStream_t st) {
  constexpr int MG = GROUP_DIMS / DM;
  EncParams& p = w.e;
  p.G = (p.M + MG - 1) / MG;
  const int W = piece(DM, p.x_bf16);
  p.vec_codes = p.M % MG == 0;
  p.vec_x = p.vec_codes && (uintptr_t)p.x % (W * (p.x_bf16 ? 2 : 4)) == 0 && p.sS % W == 0
            && p.s0 % W == 0 && p.s1 % W == 0 && p.s2 % W == 0;
  static bool attr_set = false;
  static int occ_blocks = 0;
  const size_t smem = wide_smem<DM>();
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(pq_encode_wide_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, pq_encode_wide_kernel<DM>, THREADS, smem);
    if (e != cudaSuccess) return e;
    if (occ_blocks < 1) return cudaErrorInvalidConfiguration;
    attr_set = true;
  }
  int dev, n_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  p.ntiles = (p.R + WTB - 1) / WTB;
  p.items = (long)S * p.G * p.ntiles;
  const long slots = (long)occ_blocks * n_sm;
  const int blocks = (int)(p.items < slots ? p.items : slots);
  pq_encode_wide_kernel<DM><<<blocks, THREADS, smem, st>>>(w);
  return cudaGetLastError();
}

static size_t generic_wide_smem(int dm) {
  return sizeof(float) * ((size_t)dm * GT + 2 * (size_t)(GCC / GCT) * (GCT * dm + GCT));
}

__global__ void __launch_bounds__(GT) pq_encode_wide_generic_kernel(WideParams w, int dm) {
  extern __shared__ __align__(16) float gsm[];
  const EncParams& p = w.e;
  const int TS = GCT * dm + GCT, CH = (GCC / GCT) * TS;
  float* xs = gsm;            // dm * GT: xs[j * GT + t]
  float* buf = xs + dm * GT;  // 2 x CH: the streamed chunks
  const int m = blockIdx.y, s = blockIdx.z, t = threadIdx.x;
  const float* sub = w.prep + (long)s * w.prep_bank + (long)m * w.NT * TS;
  uint16_t* out = w.codes + (long)s * p.R * p.M;
  for (long tile = blockIdx.x; tile * GT < p.R; tile += gridDim.x) {
    const long row0 = tile * GT;
    __syncthreads();  // the previous tile is done with xs and the buffers
    for (int i = t; i < CH / 4; i += GT) cp_async16(buf + 4 * i, sub + 4 * i);
    cp_async_commit();
    for (int i = t; i < GT * dm; i += GT) {
      const int tt = i / dm, j = i - tt * dm;
      const long r = row0 + tt;
      float v = 0.f;
      if (r < p.R) {
        const int dim = p.strided ? (m + j * p.M) : (m * dm + j);
        const long off = row_offset(p, s, (unsigned)r) + dim;
        if (p.x_bf16) {
          v = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.x)[off]);
        } else {
          v = reinterpret_cast<const float*>(p.x)[off];
          if (p.fast) v = round_bf16(v);
        }
      }
      xs[j * GT + tt] = v;
    }
    float best = -INFINITY;
    int idx = 0;
    for (int k = 0; k < w.nch; ++k) {
      cp_async_wait_all();
      __syncthreads();  // chunk k has landed (and xs, at k = 0); chunk k - 1 is done
      if (k + 1 < w.nch) {
        float* dst = buf + ((k + 1) & 1) * CH;
        const float* src = sub + (long)(k + 1) * CH;
        for (int i = t; i < CH / 4; i += GT) cp_async16(dst + 4 * i, src + 4 * i);
        cp_async_commit();
      }
      const float* cb = buf + (k & 1) * CH;
      for (int ti = 0; ti < GCC / GCT; ++ti) {
        const float* tp = cb + ti * TS;
        float a0 = tp[GCT * dm], a1 = tp[GCT * dm + 1], a2 = tp[GCT * dm + 2], a3 = tp[GCT * dm + 3];
        for (int j = 0; j < dm; ++j) {
          const float xv = xs[j * GT + t];
          a0 = fmaf(xv, tp[j], a0);
          a1 = fmaf(xv, tp[dm + j], a1);
          a2 = fmaf(xv, tp[2 * dm + j], a2);
          a3 = fmaf(xv, tp[3 * dm + j], a3);
        }
        const int c0 = k * GCC + ti * GCT;
        if (a0 > best) { best = a0; idx = c0; }
        if (a1 > best) { best = a1; idx = c0 + 1; }
        if (a2 > best) { best = a2; idx = c0 + 2; }
        if (a3 > best) { best = a3; idx = c0 + 3; }
      }
    }
    const long r = row0 + t;
    if (r < p.R) out[r * p.M + m] = (uint16_t)idx;
  }
}

static cudaError_t run_wide_generic(WideParams& w, int S, int dm, cudaStream_t st) {
  static size_t attr_set = 0;
  const size_t smem = generic_wide_smem(dm);
  if (smem > 48 * 1024 && smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(pq_encode_wide_generic_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = smem;
  }
  int dev, n_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long tiles = (w.e.R + GT - 1) / GT;
  const long per = (long)w.e.M * S;
  long gx = (4L * n_sm + per - 1) / per;
  if (gx > tiles) gx = tiles;
  if (gx < 1) gx = 1;
  pq_encode_wide_generic_kernel<<<dim3((unsigned)gx, (unsigned)w.e.M, (unsigned)S), GT, smem, st>>>(w, dm);
  return cudaGetLastError();
}

static bool wide_tiled(int d_m) { return d_m == 1 || d_m == 2 || d_m == 4 || d_m == 8 || d_m == 16; }

// (chunk centroids, tile centroids, floats a tile) of the wide build at this width
static void wide_geometry(int d_m, int* cc, int* ct, int* ts) {
  if (wide_tiled(d_m)) {
    *cc = WCC; *ct = ctile(d_m); *ts = tile_floats(d_m);
  } else {
    *cc = GCC; *ct = GCT; *ts = GCT * d_m + GCT;
  }
}

// Floats of scratch one bank of (M, C, d_m) codebooks needs in the wide build
// (the wrapper allocates S of them); 0 for a geometry the build does not take.
extern "C" long pq_encode_wide_scratch(int M, int C, int d_m) {
  if (M < 1 || C < 1 || C > 65536 || d_m < 1) return 0;
  if (!wide_tiled(d_m) && generic_wide_smem(d_m) > 227 * 1024) return 0;
  int cc, ct, ts;
  wide_geometry(d_m, &cc, &ct, &ts);
  const long Cp = (C + cc - 1) / cc * cc;
  return (long)M * (Cp / ct) * ts;
}

// The wide build (any C up to 65,536; the wrapper takes it above 256): x and
// strides as pq_encode, codes (S, n0 * n1 * n2, M) int16 contiguous, scratch of
// S x pq_encode_wide_scratch(M, C, d_m) floats. Returns a cudaError_t.
extern "C" int pq_encode_wide(const void* x, const void* cents, void* codes, void* scratch, int S, long n0,
                              long n1, long n2, long sS, long s0, long s1, long s2, int M, int C, int d_m,
                              int x_bf16, int strided, int fast, void* stream) {
  WideParams w;
  EncParams& p = w.e;
  p.x = x;
  p.cents = (const float*)cents;
  p.codes = nullptr;
  p.R = n0 * n1 * n2;
  if (p.R <= 0 || S <= 0) return 0;
  const long bank = pq_encode_wide_scratch(M, C, d_m);
  if (p.R >= (1L << 31) || bank == 0) return (int)cudaErrorInvalidValue;
  p.n1 = (unsigned)n1; p.n2 = (unsigned)n2;
  p.sS = sS; p.s0 = s0; p.s1 = s1; p.s2 = s2;
  p.M = M; p.C = C;
  p.x_bf16 = x_bf16; p.strided = strided; p.fast = fast;
  int cc, ct, ts;
  wide_geometry(d_m, &cc, &ct, &ts);
  p.Cp = (C + cc - 1) / cc * cc;
  w.codes = (uint16_t*)codes;
  w.prep = (const float*)scratch;
  w.prep_bank = bank;
  w.NT = p.Cp / ct;
  w.TS = ts;
  w.nch = p.Cp / cc;
  cudaStream_t st = (cudaStream_t)stream;
  const long banks_x_m = (long)S * M;
  long blocks = (banks_x_m * p.Cp + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  pq_encode_wide_prepare<<<(unsigned)blocks, 256, 0, st>>>(p.cents, (float*)scratch, banks_x_m, C, p.Cp, d_m, ct,
                                                          ts, fast);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (d_m) {
    case 1: return (int)run_wide<1>(w, S, st);
    case 2: return (int)run_wide<2>(w, S, st);
    case 4: return (int)run_wide<4>(w, S, st);
    case 8: return (int)run_wide<8>(w, S, st);
    case 16: return (int)run_wide<16>(w, S, st);
    default: return (int)run_wide_generic(w, S, d_m, st);
  }
}

extern "C" int pq_encode_tile() { return TB_MAX; }

// x: S banks of n0 * n1 * n2 rows of d = M * d_m elements (bf16 when x_bf16,
// else f32) at element strides (sS, s0, s1, s2), last dim dense. cents
// (S, M, C, d_m) f32 contiguous; codes (S, n0 * n1 * n2, M) uint8 contiguous.
// generic = 1 takes the generic-width kernel, else the tiled kernel built for
// d_m in {1, 2, 4, 8, 16} (the wrapper's encode_route decides). Returns a
// cudaError_t (0 on success); the caller validates shapes and types.
extern "C" int pq_encode(const void* x, const void* cents, void* codes, int S, long n0, long n1,
                         long n2, long sS, long s0, long s1, long s2, int M, int C, int d_m,
                         int x_bf16, int strided, int fast, int generic, void* stream) {
  EncParams p;
  p.x = x;
  p.cents = (const float*)cents;
  p.codes = (uint8_t*)codes;
  p.R = n0 * n1 * n2;
  if (p.R <= 0 || S <= 0) return 0;
  if (p.R >= (1L << 31) || C < 1 || C > 256) return (int)cudaErrorInvalidValue;
  p.n1 = (unsigned)n1; p.n2 = (unsigned)n2;
  p.sS = sS; p.s0 = s0; p.s1 = s1; p.s2 = s2;
  p.M = M; p.C = C;
  p.x_bf16 = x_bf16; p.strided = strided; p.fast = fast;
  cudaStream_t st = (cudaStream_t)stream;
  if (generic) {
    if (d_m < 1 || generic_smem((C + 3) / 4 * 4, d_m) > 227 * 1024) return (int)cudaErrorInvalidValue;
    return (int)run_generic(p, S, d_m, st);
  }
  switch (d_m) {
    case 1: return (int)run<1>(p, S, st);
    case 2: return (int)run<2>(p, S, st);
    case 4: return (int)run<4>(p, S, st);
    case 8: return (int)run<8>(p, S, st);
    case 16: return (int)run<16>(p, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
