// ttq_gemm (wide tile) — the 2-D dequant GEMM at large T on the tensor
// cores' asynchronous path (wgmma): each weight code is read and dequantized
// once for 64 tokens, x∘D⁻¹ is formed once for 256 weight rows.
//
// Replaces: src/repro/kernels/ttq_gemm.py:ttq_gemm (Pallas body _gemm_kernel,
// pallas_call at :125), at the shapes kernels/ttq_gemm.py:gemm_tile sends
// here: bf16 x, int4 codes, g a power of two >= 32, T >= WIDE_MIN_T, d <=
// WIDE_MAX_D, enough tiles (MLA's latent expansion through wkv_b,
// src/repro/models/layers.py:516: T = slots × max_len, d = kv_lora_rank).
// Computes y (T, d') = (x∘D⁻¹) · (code·s + z)ᵀ: codes 8 per int32 word, low
// bits first; per-(row, group) f32 s and z; f32 sums; bf16 output.  Every
// other shape runs the split tile of ttq_gemm.cu.
//
// Bound on the card: operations.  At deepseek-v2-lite's wkv_b (T = 1,024,
// d' = 4,096, d = 512) the 4.3 GFLOP take 4.34 µs at the bf16 tensor-core
// rate and the bytes 3.29 µs; the bf16 hi/lo pair (item 3) doubles the
// products, to ~8.7 µs.  The split tile (at most 8 tokens a block, f32 FMAs
// on CUDA cores) re-read and re-unpacked each code 128 times there and could
// not beat 64 µs even at the f32 peak.  This tile:
//
// 1. A block is WG warpgroups; its tile is 64·WG weight rows (M = 64 a
//    warpgroup) × N tokens over the whole K, through a ring of STG cp.async
//    stages of KC k (the codes, the x rows and D⁻¹ of the stage).  The tile's
//    S and Z, whole rows, are copied once before the first stage.
// 2. Products: wgmma.mma_async m64nNk16, bf16 operands, f32 accumulators.
//    A (64 rows × k16) comes from registers: the codes, dequantized there,
//    two per LOP3 + HSUB2 (exactly 128 + c, then − 128), as
//    ttq_gemm_experts.cu does; each warp's 16 rows in mma.sync's A fragment
//    layout.  B (N tokens × k16) is x̃ in shared memory, K-major core
//    matrices without swizzle, read through a descriptor.  k is permuted
//    alike in both operands: word t (codes 8t..8t+7 of a 32-k unit) of a
//    row feeds lane (g, t), nibbles (0,4) (1,5) the first k16 step and (2,6)
//    (3,7) the second, and x̃ is staged in that order.
// 3. x̃ = x∘D⁻¹ kept to ~16 bits as the bf16 pair hi = bf16(x̃), lo = bf16(x̃
//    − hi) (ttq_gemm_experts.cu's arithmetic), formed once per stage by the
//    whole block into a double-buffered pair buffer with each unit's
//    Σ(hi + lo) per token, while the stage before runs its first products.
//    hi and lo extend K: a unit's four wgmma (hi, hi, lo, lo) sum Σ c·hi +
//    Σ c·lo into one accumulator, so s and z are applied once per output and
//    group.
// 4. s and z on group partial sums: y = Σ_groups s·Σ c·x̃ + z·Σ x̃ (two FFMA
//    per output and group).  At g = 32 a group is a unit and its first wgmma
//    starts from zero; at g > 32 the accumulator runs across the group's
//    units and stages.
// 5. The tile's y is staged in shared memory and written as 16-byte rows of
//    8 outputs.
// 6. Deterministic and independent of the grid: each output's sum runs in
//    the fixed order of its own k (a unit's k16 steps hi then lo, the groups
//    in k order), whatever T, d' and the block that takes it.  So two calls
//    are bitwise equal, and a row slice or the first T' tokens are bit for
//    bit the whole launch's rows (a tensor-parallel rank's wkv_b rows are
//    world 1's).
//
// Served: WG = 4, N = 64, KC = 64, STG = 4 (256 rows × 64 tokens, 512
// threads).  What holds it above the bound (PERF.md §6, tools/wide_probe.py):
// each of a block's stages runs its copies, products, folds and conversion
// nearly in turn; TMA copies, a 128-byte swizzled B, two accumulators in
// turn, a warpgroup that only converts and a 128 × 128 tile each
// measured no faster.
#include "common.cuh"

namespace {

using namespace ttq;

constexpr int kMaxGroups = 32;           // groups a row (d/g) at most

// the 16-byte unit u of a row of codes (KC/32 units), XOR-swizzled so that
// the 8 rows a warp's lanes read in one load fall in distinct banks: the
// rows that share a 128-byte line's offset take different units there
template <int KC>
__device__ __forceinline__ int code_off(int row, int u) {
  constexpr int kU = KC / 32, kShift = kU == 4 ? 1 : 2;
  static_assert(kU == 2 || kU == 4, "64- or 128-k stages");
  return row * (KC / 2) + ((u ^ ((row >> kShift) & (kU - 1))) << 4);
}

struct Wide {
  const __nv_bfloat16* x;
  const int32_t* packed;
  const float *S, *Z, *dinv;
  __nv_bfloat16* y;
  int T, dp, d, gshift, chunks, row_tiles;
  int spr;                                // floats between rows of S, Z
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory made visible to the tensor cores'
// (async proxy) reads after the next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the descriptor of a K-major B tile without swizzle: core matrices of 8
// rows × 16 bytes, 128 bytes apart along K and 256 bytes apart along N
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// D (+)= A·B on the tensor cores of a warpgroup: m64n64k16, bf16 A from
// registers (mma.sync's A fragment per warp), B (N × k16, K-major) from
// shared memory through its descriptor; f32 D; scale_d 0 starts from zero
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// D (+)= A·B on the tensor cores of a warpgroup: m64n128k16, bf16 A from
// registers (mma.sync's A fragment per warp), B (N × k16, K-major) from
// shared memory through its descriptor; f32 D; scale_d 0 starts from zero
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc, int scale_d) {
  if constexpr (N == 64) wgmma_n64(d, a, desc, scale_d);
  else wgmma_n128(d, a, desc, scale_d);
}

// The tile: WG warpgroups of 64 rows × N tokens, KC k a stage, STG stages.
template <int WG, int N, int KC, int STG>
struct Tile {
  static constexpr int kThreads = 128 * WG;
  static constexpr int kRows = 64 * WG, kTok = N;
  static constexpr int kUnits = KC / 32, kSteps = KC / 16;
  static constexpr int kCodes = kRows * KC / 2;
  static constexpr int kX = kTok * KC * 2;
  static constexpr int kStage = kCodes + kX + KC * 4;   // + D⁻¹
  // a B tile (N tokens × k16 as core matrices [n/8][k/8][8][16 bytes]),
  // padded so that the conversion's two units fall in different banks
  static constexpr int kBT = N / 8 * 256 + 32;
  static constexpr int kPart = kSteps * kBT;      // a stage's hi (or lo)
  static constexpr int kPair = 2 * kPart + kUnits * kTok * 4;   // + Σ x̃
  static constexpr int kOutStride = kRows + 8;    // bf16 a staged y row
  static_assert(kTok * kOutStride * 2 <= 2 * kPair, "y staged in the pairs");
  // the stages and pair buffers, then the tile's S and Z, [row][group],
  // rows spr floats apart (16-byte copies; a fold's 8 rows in distinct
  // banks)
  static constexpr int kFixed = STG * kStage + 2 * kPair;
  static int smem(int spr) { return kFixed + 2 * kRows * spr * 4; }
  static_assert(kFixed + 2 * kRows * (kMaxGroups + 4) * 4 <= 227 * 1024,
                "shared memory");
  static_assert(kRows * kUnits % kThreads == 0, "code copies");
  static_assert(kTok * (KC / 8) % kThreads == 0, "x copies");
  static_assert(KC / 4 <= kThreads, "D⁻¹ copies");
};

// MULTI: g > 32, a group spans several units (and may span stages).
//
// Stage c: wait until stage c + 1 has landed; one barrier; issue the copies
// of stage c + STG - 1 into the slot stage c - 1 freed; the products of
// stage c on its codes and pair buffer c % 2, and after its first unit's
// are issued, stage c + 1's x converted into pair buffer (c + 1) % 2.
template <int WG, int N, int KC, int STG, bool MULTI>
__global__ void __launch_bounds__(128 * WG, 1) wide_kernel(Wide p) {
  using C = Tile<WG, N, KC, STG>;
  constexpr int kThreads = C::kThreads;
  constexpr int kRows = C::kRows, kTok = C::kTok, kUnits = C::kUnits;
  constexpr int kCodes = C::kCodes, kX = C::kX, kStage = C::kStage;
  constexpr int kBT = C::kBT, kPart = C::kPart, kPair = C::kPair;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const pairs = smem + STG * kStage;
  const int spr = p.spr;
  float* const sS = reinterpret_cast<float*>(smem + C::kFixed);
  float* const sZ = sS + kRows * spr;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, lg = lane >> 2, lt = lane & 3;
  const int r0 = (blockIdx.x % p.row_tiles) * kRows;
  const int t0 = (blockIdx.x / p.row_tiles) * kTok;
  const int row = wg * 64 + warp * 16 + lg;   // the lane's rows: row, row + 8
  const int wpr = p.d / 8;
  const int gpr = p.d >> p.gshift;

  // the tile's S and Z: whole rows, the widest copies gpr allows
  auto load_sz = [&]() {
    const int vec = (gpr & 3) == 0 ? 4 : (gpr & 1) == 0 ? 2 : 1;
    const int per = gpr / vec;                // copies a row
    for (int i = threadIdx.x; i < 2 * kRows * per; i += kThreads) {
      const int which = i / (kRows * per);
      const int r = (i / per) % kRows, j = (i % per) * vec;
      const int gr = min(r0 + r, p.dp - 1);
      const bool on = r0 + r < p.dp;
      const uint32_t dst = smem_addr((which ? sZ : sS) + r * spr + j);
      const float* src = (which ? p.Z : p.S) + (size_t)gr * gpr + j;
      if (vec == 4) cp_async<16>(dst, src, on);
      else if (vec == 2) cp_async<8>(dst, src, on);
      else cp_async<4>(dst, src, on);
    }
  };

  // stage c's codes, x rows (zeros past T and d) and D⁻¹ into a slot
  auto load = [&](int slot, int c) {
    const uint32_t sc = smem_addr(smem + slot * kStage);
    const uint32_t sx = sc + kCodes, sd = sx + kX;
    const int k0 = c * KC;
    const int nu = min(kUnits, (p.d - k0) >> 5);
#pragma unroll
    for (int h = 0; h < kRows * kUnits / kThreads; ++h) {
      const int i = threadIdx.x + h * kThreads;
      const int r = i / kUnits, u = i % kUnits;
      const int gr = min(r0 + r, p.dp - 1);
      cp_async<16>(sc + code_off<KC>(r, u),
                   p.packed + (size_t)gr * wpr + (k0 >> 3) + u * 4,
                   r0 + r < p.dp && u < nu);
    }
#pragma unroll
    for (int h = 0; h < kTok * (KC / 8) / kThreads; ++h) {
      const int i = threadIdx.x + h * kThreads;
      const int tt = i / (KC / 8), o = i % (KC / 8);
      const int t = min(t0 + tt, p.T - 1);
      cp_async<16>(sx + i * 16, p.x + (size_t)t * p.d + k0 + o * 8,
                   t0 + tt < p.T && o < 4 * nu);
    }
    const int i = threadIdx.x;
    if (p.dinv != nullptr && i < KC / 4)
      cp_async<16>(sd + i * 16, p.dinv + k0 + i * 4, i < 8 * nu);
  };

  // a stage's x rows → pair buffer b: per (token, 8 consecutive k of unit
  // u, lane t) the pairs (k, k + 4), k = 0..3, of hi and of lo go to k16
  // step 2u + k/2, core matrix k % 2, token row, column pair t; and each
  // unit's Σ(hi + lo) per token.  The tensor cores see the writes after
  // fence_proxy_async() and a barrier.
  auto convert = [&](int slot, int b) {
    const unsigned char* st = smem + slot * kStage;
    const __nv_bfloat16* sx =
        reinterpret_cast<const __nv_bfloat16*>(st + kCodes);
    const float* sd = reinterpret_cast<const float*>(st + kCodes + kX);
    unsigned char* pb = pairs + b * kPair;
    float* xs = reinterpret_cast<float*>(pb + 2 * kPart);
#pragma unroll
    for (int q = threadIdx.x; q < kTok * (KC / 8); q += kThreads) {
      const int tt = q / (KC / 8), o = q % (KC / 8);
      const int u = o >> 2, t = o & 3;
      float v[8];
      {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(sx + tt * KC + o * 8);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[h]));
          v[2 * h] = f.x;
          v[2 * h + 1] = f.y;
        }
      }
      if (p.dinv != nullptr) {
        const float4 d0 = *reinterpret_cast<const float4*>(sd + o * 8);
        const float4 d1 = *reinterpret_cast<const float4*>(sd + o * 8 + 4);
        v[0] *= d0.x; v[1] *= d0.y; v[2] *= d0.z; v[3] *= d0.w;
        v[4] *= d1.x; v[5] *= d1.y; v[6] *= d1.z; v[7] *= d1.w;
      }
      float sum = 0.0f;
      const int base = 2 * u * kBT + (tt >> 3) * 256 + (tt & 7) * 16 + t * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {           // the pair (k, k + 4)
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[k], v[k + 4]);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 l =
            __floats2bfloat162_rn(v[k] - hf.x, v[k + 4] - hf.y);
        const float2 lf = __bfloat1622float2(l);
        const int off = base + (k >> 1) * kBT + (k & 1) * 128;
        *reinterpret_cast<uint32_t*>(pb + off) = as_u32(h);
        *reinterpret_cast<uint32_t*>(pb + kPart + off) = as_u32(l);
        sum += (hf.x + lf.x) + (hf.y + lf.y);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (t == 0) xs[u * kTok + tt] = sum;
    }
  };

  // acc: the group's products, lane (g, t) of warp w holding rows 16w + g
  // and + 8 × tokens 8j + 2t, + 1 (j < N/8), as acc[4j .. 4j + 3]; out: the
  // sums, alike; xg (MULTI): the group's x̃ sums of the lane's tokens
  float acc[N / 2], out[N / 2], xg[N / 4];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = out[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) xg[i] = 0.0f;

  load_sz();                              // in stage 0's copy group
#pragma unroll 1
  for (int c = 0; c < STG - 1; ++c) {
    if (c < p.chunks) load(c, c);
    cp_async_commit();
  }
  cp_async_wait<STG - 2>();
  __syncthreads();
  convert(0, 0);
  fence_proxy_async();

  const int gu_mask = (1 << (p.gshift - 5)) - 1;   // units per group, - 1
#pragma unroll 1
  for (int c = 0; c < p.chunks; ++c) {
    cp_async_wait<STG - 3>();
    __syncthreads();       // stage c + 1 landed, pairs c written; the slot
                           // of stage c - 1 and pair buffer (c + 1) % 2 free
    if (c + STG - 1 < p.chunks) load((c + STG - 1) % STG, c + STG - 1);
    cp_async_commit();

    const unsigned char* st = smem + (c % STG) * kStage;
    const unsigned char* pb = pairs + (c & 1) * kPair;
    const float* xs = reinterpret_cast<const float*>(pb + 2 * kPart);
    const uint32_t pbase = smem_addr(pb);
    const int k0 = c * KC;
    const bool next = c + 1 < p.chunks;
    // every stage runs all kUnits units: past d (a last stage short of KC)
    // the codes and x were copied as zeros, so those units add exact zeros
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      // A: the unit's codes of rows row and row + 8, word lt each
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
          st + code_off<KC>(row, u) + lt * 4);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(
          st + code_off<KC>(row + 8, u) + lt * 4);
      const uint32_t a0[4] = {deq2(w0), deq2(w8), deq2(w0 >> 4),
                              deq2(w8 >> 4)};
      const uint32_t a1[4] = {deq2(w0 >> 8), deq2(w8 >> 8), deq2(w0 >> 12),
                              deq2(w8 >> 12)};
      // the unit's four k16 products, hi then lo (from zero at a group's
      // first unit)
      const uint32_t hi = pbase + 2 * u * kBT, lo = hi + kPart;
      wgmma_fence();
      wgmma<N>(acc, a0, kmajor_desc(hi),
               MULTI && (((k0 >> 5) + u) & gu_mask) != 0);
      wgmma<N>(acc, a1, kmajor_desc(hi + kBT), 1);
      wgmma<N>(acc, a0, kmajor_desc(lo), 1);
      wgmma<N>(acc, a1, kmajor_desc(lo + kBT), 1);
      wgmma_commit();
      if (u == 0 && next) convert((c + 1) % STG, (c + 1) & 1);
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i]));
      if (MULTI) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const float2 x2 = *reinterpret_cast<const float2*>(
              xs + u * kTok + 8 * j + 2 * lt);
          xg[2 * j] += x2.x;
          xg[2 * j + 1] += x2.y;
        }
      }
      // the group's end: y += s·Σ c·x̃ + z·Σ x̃ (a group past d adds
      // nothing: its S and Z rows end at d/g)
      const int grp = (k0 + 32 * u) >> p.gshift;
      if (grp < gpr && (!MULTI || (((k0 >> 5) + u + 1) & gu_mask) == 0)) {
        const float s0 = sS[row * spr + grp], s1 = sS[(row + 8) * spr + grp];
        const float z0 = sZ[row * spr + grp], z1 = sZ[(row + 8) * spr + grp];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          float x0, x1;
          if (MULTI) {
            x0 = xg[2 * j];
            x1 = xg[2 * j + 1];
            xg[2 * j] = xg[2 * j + 1] = 0.0f;
          } else {
            const float2 x2 = *reinterpret_cast<const float2*>(
                xs + u * kTok + 8 * j + 2 * lt);
            x0 = x2.x;
            x1 = x2.y;
          }
          float* o = out + 4 * j;
          o[0] = fmaf(z0, x0, fmaf(s0, acc[4 * j], o[0]));
          o[1] = fmaf(z0, x1, fmaf(s0, acc[4 * j + 1], o[1]));
          o[2] = fmaf(z1, x0, fmaf(s1, acc[4 * j + 2], o[2]));
          o[3] = fmaf(z1, x1, fmaf(s1, acc[4 * j + 3], o[3]));
        }
      }
    }
    if (next) fence_proxy_async();
  }
  cp_async_wait<0>();

  // y through shared memory (the pair buffers): the tile as [token][row]
  // bf16, then 16-byte rows of 8 outputs to global memory
  __syncthreads();
  __nv_bfloat16* const so = reinterpret_cast<__nv_bfloat16*>(pairs);
  constexpr int kOS = C::kOutStride;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int tok = 8 * j + 2 * lt;
    so[tok * kOS + row] = __float2bfloat16_rn(out[4 * j]);
    so[(tok + 1) * kOS + row] = __float2bfloat16_rn(out[4 * j + 1]);
    so[tok * kOS + row + 8] = __float2bfloat16_rn(out[4 * j + 2]);
    so[(tok + 1) * kOS + row + 8] = __float2bfloat16_rn(out[4 * j + 3]);
  }
  __syncthreads();
  if ((p.dp & 7) == 0) {
#pragma unroll
    for (int h = 0; h < kTok * (kRows / 8) / kThreads; ++h) {
      const int i = threadIdx.x + h * kThreads;
      const int tt = i / (kRows / 8), o = (i % (kRows / 8)) * 8;
      if (t0 + tt < p.T && r0 + o < p.dp)
        *reinterpret_cast<uint4*>(p.y + (size_t)(t0 + tt) * p.dp + r0 + o) =
            *reinterpret_cast<const uint4*>(so + tt * kOS + o);
    }
  } else {
    for (int i = threadIdx.x; i < kTok * kRows; i += kThreads) {
      const int tt = i / kRows, o = i % kRows;
      if (t0 + tt < p.T && r0 + o < p.dp)
        p.y[(size_t)(t0 + tt) * p.dp + r0 + o] = so[tt * kOS + o];
    }
  }
}

template <int WG, int N, int KC, int STG>
int launch(Wide p, int g, cudaStream_t stream) {
  using C = Tile<WG, N, KC, STG>;
  void (*kern)(Wide) = g == 32 ? &wide_kernel<WG, N, KC, STG, false>
                                : &wide_kernel<WG, N, KC, STG, true>;
  static bool ready[2] = {false, false};
  if (!ready[g != 32]) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::smem(kMaxGroups + 4));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    ready[g != 32] = true;
  }
  p.chunks = (p.d + KC - 1) / KC;
  p.row_tiles = (p.dp + C::kRows - 1) / C::kRows;
  p.spr = ((p.d >> p.gshift) + 3) / 4 * 4 + 4;
  const int tiles = p.row_tiles * ((p.T + C::kTok - 1) / C::kTok);
  kern<<<tiles, C::kThreads, C::smem(p.spr), stream>>>(p);
  return (int)cudaGetLastError();
}

Wide args(const void* x, const int32_t* packed, const float* S,
          const float* Z, const float* dinv, void* y, int T, int dp, int d,
          int g) {
  Wide p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.packed = packed;
  p.S = S;
  p.Z = Z;
  p.dinv = dinv;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.T = T;
  p.dp = dp;
  p.d = d;
  p.gshift = 0;
  while ((1 << p.gshift) < g) ++p.gshift;
  return p;
}

bool bad_args(int T, int dp, int d, int bits, int g) {
  return T <= 0 || dp <= 0 || d <= 0 || bits != 4 || g < 32 ||
         (g & (g - 1)) || d % g || d / g > kMaxGroups;
}

}  // namespace

// The 2-D ttq_gemm on the wide tile: x (T, d) bf16; packed (d', d/8) int32 of
// int4 codes (bits must be 4); S, Z (d', d/g) f32 with g a power of two >= 32
// dividing d and d/g <= 32; dinv (d,) f32 or null; y (T, d') bf16.  All
// contiguous and 16-byte aligned.  Any T >= 1 (kernels/ttq_gemm.py:gemm_tile
// chooses the shapes that come here).
extern "C" int ttq_gemm_wide_launch(const void* x, const int32_t* packed,
                                    const float* S, const float* Z,
                                    const float* dinv, void* y, int T, int dp,
                                    int d, int bits, int g,
                                    void* stream_ptr) {
  if (bad_args(T, dp, d, bits, g)) return (int)cudaErrorInvalidValue;
  return launch<4, 64, 64, 4>(args(x, packed, S, Z, dinv, y, T, dp, d, g), g,
                              (cudaStream_t)stream_ptr);
}

#ifdef WIDE_PROBE
// Measurement only (tools/wide_probe.py builds this file with -DWIDE_PROBE
// into a library of its own): the same launch on another tile, `variant`
// of tools/wide_probe.py's VARIANTS.
extern "C" int ttq_gemm_wide_probe_launch(int variant, const void* x,
                                          const int32_t* packed,
                                          const float* S, const float* Z,
                                          const float* dinv, void* y, int T,
                                          int dp, int d, int g,
                                          void* stream_ptr) {
  if (bad_args(T, dp, d, 4, g)) return (int)cudaErrorInvalidValue;
  const Wide p = args(x, packed, S, Z, dinv, y, T, dp, d, g);
  const cudaStream_t st = (cudaStream_t)stream_ptr;
  switch (variant) {
    case 0: return launch<4, 64, 64, 4>(p, g, st);
    case 1: return launch<2, 128, 64, 4>(p, g, st);
    case 2: return launch<2, 64, 64, 4>(p, g, st);
    case 3: return launch<4, 64, 64, 3>(p, g, st);
    case 4: return launch<4, 64, 64, 5>(p, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
