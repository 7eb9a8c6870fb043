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
// d_m 1-16 this is CUDA-core work, and the scores are the same f32 sums
// (-0.5 ||c||^2 + x_0 c_0 + ... as a chain of FMAs) in every version.
//
// Bound. rows x M x C x (2 d_m + 1) operations against 67 TFLOP/s f32, and
// (x + codes) bytes against 3.35 TB/s: at 1.024 M rows of d = 128 bf16 that
// is 1.25 ms (dm2, C = 256) or 0.56 ms (dm4, C = 128) by operations and
// 0.10 ms by bytes. What the SM can issue sets the kernel's own floor: per
// (token, subspace, centroid) d_m FMAs on the FMA pipe and whatever the
// argmax costs on the ALU pipe, which runs at half the FMA pipe's rate. With
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
