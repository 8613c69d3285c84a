// ttq_gemm — fused dequant GEMM for the decode shape, K split across a
// thread-block cluster and reduced in distributed shared memory.
//
// Replaces: src/repro/kernels/ttq_gemm.py:ttq_gemm (Pallas body _gemm_kernel).
// Computes y (T, d') = (x∘D⁻¹)(T, d) · (code·s + z)ᵀ with codes unpacked
// from int32 words (32/bits per word, low bits first), per-(row, group) f32
// scale s and zero z, f32 accumulation, output in x's dtype.
//
// Bound on the card: bytes.  At decode T is 1-8 per block, so each weight
// byte feeds at most 2·T·(8/bits) flops, far below the ~295 flop/byte where
// the H100 stops being memory bound; the floor is packed codes + S/Z over
// 3.35 TB/s.  Every weight byte is read once, as coalesced 16-byte loads.
//
// Tile: a block of 8 warps owns 32 output rows (4 per warp) and one slice of
// K.  Each lane streams uint4 words of its warp's 4 rows, unpacks them with
// shift/mask, dequantizes with its group's s and z (loaded once per group:
// NG groups per uint4, g a power of two, so the group index is a shift), and
// multiplies against x∘D⁻¹ staged in shared memory in f32 for all tokens:
// every staged x value serves 4 rows.  The next uint4 words (and, with one
// or two groups per uint4, their s and z) are loaded before the current
// ones' FMAs, so a lane keeps 2·4 uint4 loads in flight.  32 rows (not 16)
// halve the staging of x per weight byte; 4 rows and at most 8 tokens per
// block keep acc[4][8] in registers without spilling on the main path.
//
// Split: the S blocks of one cluster (S in {1, 2, 4, 8}; 8 is the portable
// cluster limit, set at launch and never changed here) share a row tile, and
// rank r takes the contiguous K slice [r·d/S, (r+1)·d/S).  So a block stages
// only its slice of x∘D⁻¹: once where it fits in kStageBytes, in chunks along
// K otherwise (XOR-swizzled by 16-byte chunk, so the lanes of a quarter-warp,
// which read addresses 128 B apart, hit distinct banks).  A narrow row count
// (d' = 3072 is 96 tiles) still puts a block on every SM, and no block walks
// a wide d (24576) alone.  The wrapper picks S (kernels/ttq_gemm.py:
// gemm_splits); a split whose slice is not whole groups and uint4 words is
// refused with cudaErrorInvalidValue.
//
// Reduction, in one launch and deterministic: each warp closes its rows with
// a shuffle tree into the block's part[32][TT] in shared memory; a cluster
// barrier; rank 0 reads part of ranks 0, 1, …, S−1 through distributed
// shared memory, adds them in that fixed order, casts and stores; a second
// cluster barrier keeps every rank's shared memory alive until rank 0 has
// read it.  No atomics and no workspace: for a given shape and S the sum
// order is fixed, so two calls are bitwise equal.  T > 8 runs more token
// tiles on the grid's y axis, so the kernel is right at every T.
//
// Experts: gridDim.z = E batches E independent problems of one shape in one
// launch (the reference vmaps ttq_gemm over the expert axis of a MoE weight,
// src/repro/models/layers.py:_expert_mm, one pallas_call with a leading
// batch grid axis).  Slice z reads x, codes, S, Z and D⁻¹ and writes y at
// per-expert offsets (x's stride may be 0: the gate and up projections read
// the same tokens for every expert).  A block's work inside its slice is the
// 2-D kernel's, so expert e's rows are bit for bit a 2-D launch on expert e
// at the same split.  The 2-D entry is the batched one at E = 1.
//
// Other group sizes: the tile above needs g a power of two, at least one
// code word (32/bits), and rows of whole uint4 words (d % (4·32/bits) = 0).
// Every other (d, g, bits) with whole words and groups (the reference's
// Pallas kernel takes d <= 256 with g and 32/bits dividing d, or 256 | d
// with g dividing 256) runs gemm_generic: the same 32-row tile, one int32
// word per lane at a time, the group index by division and x read through
// the cache, no K split.  It is right, not fast: no served shape runs it.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kStageBytes = 96 * 1024;  // staged x∘D⁻¹ per block, at most
constexpr int kMaxSplit = 8;

__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

// float4 row stride of the staged x for chunks of kc floats: a multiple of 8,
// so the swizzle stays inside the row.
__host__ __device__ __forceinline__ int stage_stride4(int kc) {
  return (kc / 4 + 7) & ~7;
}

// Per-expert element strides of one batched launch (all 0 at E = 1; x's
// and D⁻¹'s may be 0 for operands every expert shares).
struct Strides {
  long long x, packed, sz, dinv, y;
};

// a kernel's operands moved to expert blockIdx.z's slice
#define TTQ_AT_EXPERT(st)                                         \
  do {                                                            \
    const size_t e_ = blockIdx.z, es_ = x_bf16 ? 2 : 4;           \
    x = static_cast<const char*>(x) + e_ * (size_t)(st).x * es_;  \
    y = static_cast<char*>(y) + e_ * (size_t)(st).y * es_;        \
    packed += e_ * (size_t)(st).packed;                           \
    S += e_ * (size_t)(st).sz;                                    \
    Z += e_ * (size_t)(st).sz;                                    \
    if (dinv != nullptr) dinv += e_ * (size_t)(st).dinv;          \
  } while (0)

__device__ __forceinline__ float load1(const void* x, int x_bf16,
                                       size_t off) {
  return x_bf16 ? __bfloat162float(
                      static_cast<const __nv_bfloat16*>(x)[off])
                : static_cast<const float*>(x)[off];
}

// Any g dividing d, and rows of whole int32 words: the generic tile (see the
// note above).  Lane l of a warp takes words l, l + 32, ... of its warp's R
// rows; each code's group is k / g; x∘D⁻¹ is formed per element as the fast
// kernel stages it.  A warp closes its rows with a shuffle tree.
template <int TT, int BITS>
__global__ void __launch_bounds__(kThreads) gemm_generic(
    const void* __restrict__ x, int x_bf16, const int32_t* __restrict__ packed,
    const float* __restrict__ S, const float* __restrict__ Z,
    const float* __restrict__ dinv, void* __restrict__ y, int T, int dp, int d,
    int g, Strides st) {
  constexpr int R = kRowsPerWarp;
  constexpr int PER = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  TTQ_AT_EXPERT(st);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows + warp * R;
  const int t0 = blockIdx.y * TT;
  const int wpr = d / PER, gpr = d / g;
  float acc[R][TT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[r][t] = 0.0f;
  for (int wi = lane; wi < wpr; wi += 32) {
    uint32_t wd[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      wd[r] = row0 + r < dp
                  ? (uint32_t)__ldg(packed + (size_t)(row0 + r) * wpr + wi)
                  : 0u;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = wi * PER + i, gi = k / g;
      const float dv = dinv != nullptr ? __ldg(dinv + k) : 1.0f;
      float xv[TT];
#pragma unroll
      for (int t = 0; t < TT; ++t)
        xv[t] = t0 + t < T ? load1(x, x_bf16, (size_t)(t0 + t) * d + k) * dv
                           : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r >= dp) continue;
        const size_t gix = (size_t)(row0 + r) * gpr + gi;
        const float w = fmaf((float)((wd[r] >> (i * BITS)) & MASK),
                             __ldg(S + gix), __ldg(Z + gix));
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[r][t] = fmaf(xv[t], w, acc[r][t]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float v = ttq::warp_sum(acc[r][t]);
      const int row = row0 + r;
      if (lane == 0 && row < dp && t0 + t < T) {
        const size_t off = (size_t)(t0 + t) * dp + row;
        if (x_bf16) ttq::store1(static_cast<__nv_bfloat16*>(y) + off, v);
        else ttq::store1(static_cast<float*>(y) + off, v);
      }
    }
}

template <int TT, int BITS>
int launch_generic(const void* x, int x_bf16, const int32_t* packed,
                   const float* S, const float* Z, const float* dinv, void* y,
                   int E, int T, int dp, int d, int g, Strides st,
                   cudaStream_t stream) {
  const dim3 grid((dp + kRows - 1) / kRows, (T + TT - 1) / TT, E);
  gemm_generic<TT, BITS><<<grid, kThreads, 0, stream>>>(
      x, x_bf16, packed, S, Z, dinv, y, T, dp, d, g, st);
  return (int)cudaGetLastError();
}

// NG: groups per uint4 of codes (1, 2 or 4; g is a power of two >= 32/BITS).
// EXPERTS: whether blockIdx.z picks an expert's slice; a 2-D launch (E = 1)
// takes the instantiation without it, whose code is the 2-D kernel's alone
// (moving the operand pointers costs registers the 2-D tile has no room for).
template <int TT, int BITS, int NG, bool EXPERTS>
__global__ void __launch_bounds__(kThreads) gemm_kernel(
    const void* __restrict__ x, int x_bf16, const int32_t* __restrict__ packed,
    const float* __restrict__ S, const float* __restrict__ Z,
    const float* __restrict__ dinv, void* __restrict__ y, int T, int dp, int d,
    int gshift, int ks, int kc, Strides st) {
  constexpr int R = kRowsPerWarp;
  constexpr int PER = 32 / BITS;
  constexpr int EPV = 4 * PER;            // elements per uint4 of codes
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ float4 xs[];          // TT rows of kc4 float4
  __shared__ float part[kRows * TT];      // this block's partial sums
  if constexpr (EXPERTS) TTQ_AT_EXPERT(st);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile0 = (blockIdx.x / split) * kRows;
  const int row0 = tile0 + warp * R;
  const int t0 = blockIdx.y * TT;
  const int kc4 = stage_stride4(kc);
  const int k_lo = rank * ks, k_hi = k_lo + ks;
  const int wpr = d / PER;                // int32 words per row
  const int gpr = d >> gshift;
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) live[r] = row0 + r < dp;

  float acc[R][TT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[r][t] = 0.0f;

  // the R rows' uint4 words at vector vi of the chunk at c0
  auto fetch_words = [&](int c0, int nvec, int vi, uint4 (&u)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      u[r] = live[r] && vi < nvec
                 ? __ldg(reinterpret_cast<const uint4*>(
                             packed + (size_t)(row0 + r) * wpr + c0 / PER) +
                         vi)
                 : make_uint4(0u, 0u, 0u, 0u);
  };
  // group j of vector vi's NG groups: its s and z for the R rows, loaded once
  auto fetch_group = [&](int c0, int nvec, int vi, int j, float (&s)[R][NG],
                         float (&z)[R][NG]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool on = live[r] && vi < nvec;
      const size_t gi = (size_t)(row0 + r) * gpr +
                        ((c0 + vi * EPV + j * (EPV / NG)) >> gshift);
      s[r][j] = on ? __ldg(S + gi) : 0.0f;
      z[r][j] = on ? __ldg(Z + gi) : 0.0f;
    }
  };
  // With one or two groups per vector, a vector's s and z are loaded with
  // its words, one vector ahead.  With four (a group per word), two vectors'
  // s and z would spill: each word's are loaded just before its FMAs.
  constexpr bool kGroupsAhead = NG < 4;
  auto fetch_groups = [&](int c0, int nvec, int vi, float (&s)[R][NG],
                          float (&z)[R][NG]) {
    if constexpr (kGroupsAhead) {
#pragma unroll
      for (int j = 0; j < NG; ++j) fetch_group(c0, nvec, vi, j, s, z);
    }
  };

  for (int c0 = k_lo; c0 < k_hi; c0 += kc) {
    const int clen = min(kc, k_hi - c0);
    const int n4 = clen / 4, nvec = clen / EPV;
    __syncthreads();                      // the previous chunk is consumed
    // a column of four k for all TT tokens per step: its TT + 1 loads (x
    // rows and D⁻¹) are in flight together
#pragma unroll (TT <= 4 ? 4 : 1)
    for (int c = threadIdx.x; c < n4; c += kThreads) {
      const int k = c0 + 4 * c;
      float dv[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (dinv != nullptr) ttq::load4(dinv + k, dv);
      float v[TT][4];
#pragma unroll
      for (int t = 0; t < TT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[t][e] = 0.0f;
        const size_t off = (size_t)(t0 + t) * d + k;
        if (t0 + t < T) {
          if (x_bf16)
            ttq::load4(static_cast<const __nv_bfloat16*>(x) + off, v[t]);
          else
            ttq::load4(static_cast<const float*>(x) + off, v[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < TT; ++t)
        xs[t * kc4 + swz(c)] = make_float4(v[t][0] * dv[0], v[t][1] * dv[1],
                                           v[t][2] * dv[2], v[t][3] * dv[3]);
    }
    __syncthreads();
    uint4 u[R];
    float s[R][NG], z[R][NG];
    fetch_words(c0, nvec, lane, u);
    fetch_groups(c0, nvec, lane, s, z);
    for (int vi = lane; vi < nvec; vi += 32) {
      // the next vector is loaded before this vector's FMAs: 2·R uint4
      // loads in flight per lane
      uint4 un[R];
      float sn[R][NG], zn[R][NG];
      fetch_words(c0, nvec, vi + 32, un);
      fetch_groups(c0, nvec, vi + 32, sn, zn);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        constexpr int WPG = 4 / NG;       // words per group in a vector
        if constexpr (!kGroupsAhead) fetch_group(c0, nvec, vi, w, s, z);
        uint32_t wd[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          wd[r] = w == 0 ? u[r].x : w == 1 ? u[r].y : w == 2 ? u[r].z : u[r].w;
#pragma unroll
        for (int h = 0; h < PER / 4; ++h) {
          float wv[R][4];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t code = (wd[r] >> ((h * 4 + e) * BITS)) & MASK;
              wv[r][e] = fmaf((float)code, s[r][w / WPG], z[r][w / WPG]);
            }
          const int c = (vi * EPV + w * PER) / 4 + h;
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            const float4 xv = xs[t * kc4 + swz(c)];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float a = acc[r][t];
              a = fmaf(xv.x, wv[r][0], a);
              a = fmaf(xv.y, wv[r][1], a);
              a = fmaf(xv.z, wv[r][2], a);
              a = fmaf(xv.w, wv[r][3], a);
              acc[r][t] = a;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        u[r] = un[r];
        if constexpr (kGroupsAhead) {
#pragma unroll
          for (int j = 0; j < NG; ++j) s[r][j] = sn[r][j], z[r][j] = zn[r][j];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float v = ttq::warp_sum(acc[r][t]);
      if (lane == 0) part[(warp * R + r) * TT + t] = v;
    }
  cluster.sync();                         // every rank's part is written
  if (rank == 0) {
    for (int i = threadIdx.x; i < kRows * TT; i += kThreads) {
      float p[kMaxSplit];
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        p[r] = r < split ? cluster.map_shared_rank(&part[0], r)[i] : 0.0f;
      float v = p[0];
#pragma unroll
      for (int r = 1; r < kMaxSplit; ++r)
        if (r < split) v += p[r];         // ranks in order: deterministic
      const int row = tile0 + i / TT, t = t0 + i % TT;
      const size_t off = (size_t)t * dp + row;
      if (row < dp && t < T) {
        if (x_bf16) ttq::store1(static_cast<__nv_bfloat16*>(y) + off, v);
        else ttq::store1(static_cast<float*>(y) + off, v);
      }
    }
  }
  cluster.sync();                         // rank 0 has read every part
}

template <int TT, int BITS, int NG, bool EXPERTS>
int launch_tile(const void* x, int x_bf16, const int32_t* packed,
                const float* S, const float* Z, const float* dinv, void* y,
                int E, int T, int dp, int d, int gshift, int split, Strides st,
                cudaStream_t stream) {
  constexpr int EPV = 4 * (32 / BITS);
  auto kern = gemm_kernel<TT, BITS, NG, EXPERTS>;
  const int ks = d / split;
  // the largest chunk of whole uint4 words whose TT staged rows fit
  const int cap = kStageBytes / (TT * 4) / 64 * 64;
  const int kc = ks <= cap ? ks : cap / EPV * EPV;
  const size_t smem = (size_t)TT * stage_stride4(kc) * sizeof(float4);
  if (smem + kRows * TT * sizeof(float) > 48 * 1024) {  // with part[]
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(((dp + kRows - 1) / kRows) * split, (T + TT - 1) / TT, E);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, x, x_bf16, packed, S, Z, dinv, y, T, dp, d, gshift, ks, kc,
      st);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <int TT, int BITS, int NG>
int launch(const void* x, int x_bf16, const int32_t* packed, const float* S,
           const float* Z, const float* dinv, void* y, int E, int T, int dp,
           int d, int gshift, int split, Strides st, cudaStream_t stream) {
  if (E > 1)
    return launch_tile<TT, BITS, NG, true>(x, x_bf16, packed, S, Z, dinv, y,
                                           E, T, dp, d, gshift, split, st,
                                           stream);
  return launch_tile<TT, BITS, NG, false>(x, x_bf16, packed, S, Z, dinv, y,
                                          E, T, dp, d, gshift, split, st,
                                          stream);
}

// One launch's arguments past the template parameters.
struct Args {
  const void* x;
  int x_bf16;
  const int32_t* packed;
  const float *S, *Z, *dinv;
  void* y;
  int E, T, dp, d, g, gshift, split;
  Strides st;
  cudaStream_t stream;
};

template <int TT, int BITS>
int by_groups(const Args& a) {
  if (a.gshift < 0)                       // the generic tile
    return launch_generic<TT, BITS>(a.x, a.x_bf16, a.packed, a.S, a.Z, a.dinv,
                                    a.y, a.E, a.T, a.dp, a.d, a.g, a.st,
                                    a.stream);
  const int ng = (4 * (32 / BITS)) >> a.gshift;  // 0: a group spans vectors
#define TTQ_GEMM_NG(N)                                                      \
  return launch<TT, BITS, N>(a.x, a.x_bf16, a.packed, a.S, a.Z, a.dinv, a.y, \
                             a.E, a.T, a.dp, a.d, a.gshift, a.split, a.st,   \
                             a.stream)
  if (ng >= 4) TTQ_GEMM_NG(4);
  if (ng == 2) TTQ_GEMM_NG(2);
  TTQ_GEMM_NG(1);
#undef TTQ_GEMM_NG
}

template <int TT>
int by_bits(const Args& a, int bits) {
  if (bits == 2) return by_groups<TT, 2>(a);
  if (bits == 4) return by_groups<TT, 4>(a);
  return by_groups<TT, 8>(a);
}

// Checks one launch and picks its tile: the fast one where g is a power of
// two >= 32/bits and rows are whole uint4 words (then the split's slice must
// be whole groups and words too), else the generic one at split 1.
int run(Args a, int bits) {
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  const int per = 32 / bits;
  if (a.E <= 0 || a.T <= 0 || a.dp <= 0 || a.d <= 0 || a.g <= 0 ||
      a.d % per || a.d % a.g)
    return (int)cudaErrorInvalidValue;
  const bool fast =
      a.g >= per && !(a.g & (a.g - 1)) && a.d % (4 * per) == 0;
  if (fast) {
    if ((a.split != 1 && a.split != 2 && a.split != 4 &&
         a.split != kMaxSplit) ||
        a.d % a.split)
      return (int)cudaErrorInvalidValue;
    const int ks = a.d / a.split;
    if (ks % (4 * per) || ks % a.g) return (int)cudaErrorInvalidValue;
    a.gshift = 0;
    while ((1 << a.gshift) < a.g) ++a.gshift;
  } else {
    if (a.split != 1) return (int)cudaErrorInvalidValue;
    a.gshift = -1;
  }
  if (a.T <= 1) return by_bits<1>(a, bits);
  if (a.T <= 2) return by_bits<2>(a, bits);
  if (a.T <= 4) return by_bits<4>(a, bits);
  return by_bits<8>(a, bits);
}

}  // namespace

extern "C" int ttq_gemm_launch(const void* x, int x_bf16, const int32_t* packed,
                               const float* S, const float* Z,
                               const float* dinv, void* y, int T, int dp,
                               int d, int bits, int g, int split,
                               void* stream_ptr) {
  return run(Args{x, x_bf16, packed, S, Z, dinv, y, 1, T, dp, d, g, 0, split,
                  Strides{0, 0, 0, 0, 0}, (cudaStream_t)stream_ptr},
             bits);
}

// E experts in one launch: x (E, T, d), or (T, d) shared by every expert when
// x_shared; packed (E, d', d·bits/32); S, Z (E, d', d/g); dinv (E, d) or
// null; y (E, T, d').  All contiguous.
extern "C" int ttq_gemm_experts_launch(
    const void* x, int x_bf16, int x_shared, const int32_t* packed,
    const float* S, const float* Z, const float* dinv, void* y, int E, int T,
    int dp, int d, int bits, int g, int split, void* stream_ptr) {
  if ((bits != 2 && bits != 4 && bits != 8) || g <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides st{x_shared ? 0 : (long long)T * d,
                   (long long)dp * (d / (32 / bits)), (long long)dp * (d / g),
                   d, (long long)T * dp};
  return run(Args{x, x_bf16, packed, S, Z, dinv, y, E, T, dp, d, g, 0, split,
                  st, (cudaStream_t)stream_ptr},
             bits);
}
