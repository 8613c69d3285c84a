// ttq_gemm_experts (mma tile) — the expert-batched dequant GEMM of the MoE
// decode path on tensor cores: codes dequantized two at a time in registers,
// a persistent walk over (expert, row tile) items, a cp.async ring.
//
// Replaces: src/repro/kernels/ttq_gemm.py:ttq_gemm (Pallas body _gemm_kernel)
// under jax.vmap over the expert axis (src/repro/models/layers.py:
// _expert_mm).  Computes y (E, T, d') = (x∘D⁻¹) · (code·s + z)ᵀ per expert,
// x (T, d) shared by every expert or (E, T, d) one per expert, bf16; codes
// int4, 8 per int32 word, low bits first; per-(row, group) f32 s and z, g a
// power of two >= 32; f32 sums; bf16 output.  Other shapes (bits 2 and 8,
// other g, f32 x) run the batched CUDA-core tile of ttq_gemm.cu
// (kernels/ttq_gemm.py:experts_tile decides).
//
// Bound on the card: bytes.  At T <= 16 tokens each weight byte feeds at
// most 2·2·16 flops, far below the ~295 flop/byte where the H100 stops being
// memory bound; the floor is codes + S/Z over 3.35 TB/s.  What kept the
// CUDA-core tile from it is instructions: per code a shift, a mask, an int to
// float conversion and a dequant FMA, then T FMAs (~8-9 instructions a
// code), at rates that alone need more than the byte bound; and a 32-row
// block that stages all of x∘D⁻¹ before its first weight load and walks only
// 2-3 uint4 per lane.  This tile:
//
// 1. Tensor cores for the product: mma.sync.m16n8k16, bf16 operands, f32
//    accumulators.  A (16 rows × 16 k) is the weights, B (16 k × 8 columns)
//    is x̃ = x∘D⁻¹.
// 2. Codes dequantized in registers, two per instruction: one LOP3 puts two
//    nibbles under the bf16 exponent of 128 (0x4300), giving 128 + c
//    exactly; one HSUB2 takes 128 away, also exactly.  s and z go on the
//    partial sums: y = Σ_groups s·Σ_{k∈g} c·x̃ + z·Σ_{k∈g} x̃, so the
//    accumulators of one group's mma steps are folded with that group's s
//    and z, and the x̃ sums of each 32-k unit are formed once per stage,
//    shared by the item's rows.
// 3. x̃ kept to ~16 bits as a bf16 pair: hi = bf16(x̃), lo = bf16(x̃ − hi).
//    One n8 tile holds 4 tokens' hi (columns 0-3) and lo (columns 4-7), so
//    T <= 4 costs one mma per k16 step; a shuffle adds lo to hi at the end.
//    Up to 16 tokens are 4 n-tiles that reuse each dequantized A fragment,
//    so the weights are read once for T <= 16 (T > 16: token chunks of 16).
// 4. k permuted alike in both operands.  Lane (g, t) of a warp (g = lane/4,
//    t = lane%4) takes, of each 32-k unit of codes, word t (8 codes) of rows
//    g and g+8: nibbles (0,4) and (1,5) are its A fragment of the first k16
//    step, (2,6) and (3,7) of the second.  x̃ is staged in that order: for
//    each unit and column, the 16 bytes lane t reads are the bf16 pairs
//    (k0,k4) (k1,k5) (k2,k6) (k3,k7) of k = 32u + 8t + 0..7, its B
//    fragments of both steps in one 16-byte load.  The codes keep
//    ttq_quantize's (d', d/8) int32 layout: each 16-byte unit of a row is
//    copied to shared memory XOR-swizzled by row, and one ldmatrix.x4 gives
//    a lane its words of two units for rows g and g+8 without bank
//    conflicts.
// 5. A persistent, pipelined walk.  An item is 64 rows (4 warps × 16) of one
//    expert and up to 16 tokens over the whole K; the grid is as many blocks
//    as fit on the card (4 per SM at T <= 4), and block b takes items b,
//    b + grid, b + 2·grid, ... (strided, so each SM's blocks carry nearly
//    equal work).  The block's (item, K chunk of 256) steps form one stream
//    through a ring of 3 stages fed by 16-byte cp.async (codes, S, Z, the x
//    rows and D⁻¹ of the chunk): the next steps' copies, the next item's
//    included, are in flight while this step's mma run.  Each stage's x
//    chunk becomes its x̃ pair in shared memory one step ahead, in one of two
//    buffers (a few instructions per x̃, shared by the item's 64 rows), so
//    shared memory does not grow with d (llama4-scout's wd has d = 8192) and
//    a step needs one barrier.  No K split, no cluster, no cross-block
//    reduction.
//
//    What bounds it now (PERF.md): the copy ring alone
//    (ttq_gemm_experts_mma_copies_launch) reaches ~62% of the byte bound at
//    deepseek-v2-lite's expert shapes and ~73% at llama4-scout's, and the
//    tile 54% and 62-67%.  Four stages (three blocks per SM), five or six
//    (two), 512-k stages (two), eight warps a block, bulk L2 prefetches of
//    a row's next four stages and cp.async's L2::128B / L2::256B hints each
//    measured no better.
// 6. Deterministic and independent of E: each output's sums run in the
//    fixed order of its own item's walk (the mma steps of a group, the
//    groups in k order, hi + lo), whatever block takes the item.  So expert
//    e's rows are bit for bit the same whatever E, the grid, or the experts
//    that share the launch (an expert-parallel rank's E/n experts are the
//    world-1 experts' rows).
#include "common.cuh"

namespace {

using namespace ttq;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;        // output rows per item
constexpr int kTokens = 16;               // tokens per item, at most
constexpr int kKC = 256;                  // K per stage
constexpr int kUnits = kKC / 32;          // 32-k units (16 code bytes a row)
constexpr int kStages = 3;
constexpr int kMinBlocks = 4;           // per SM: at most 128 registers

// shared memory of one stage and of one x̃ pair buffer, for NT n-tiles
__host__ __device__ constexpr int codes_bytes() { return kRows * kKC / 2; }
__host__ __device__ constexpr int sz_bytes() { return kRows * kUnits * 4; }
__host__ __device__ constexpr int x_bytes(int nt) { return nt * 4 * kKC * 2; }
__host__ __device__ constexpr int dinv_bytes() { return kKC * 4; }
__host__ __device__ constexpr int stage_bytes(int nt) {
  return codes_bytes() + 2 * sz_bytes() + x_bytes(nt) + dinv_bytes();
}
__host__ __device__ constexpr int xt_bytes(int nt) {
  return kUnits * nt * 8 * 64;
}
__host__ __device__ constexpr int xs_bytes(int nt) {
  return kUnits * nt * 8 * 4;
}
__host__ __device__ constexpr int pair_bytes(int nt) {
  return xt_bytes(nt) + xs_bytes(nt);
}
__host__ __device__ constexpr int smem_bytes(int nt) {   // two pair buffers
  return kStages * stage_bytes(nt) + 2 * pair_bytes(nt);
}

// the 16-byte unit u of a 128-byte row of codes, XOR-swizzled so that the 8
// rows one ldmatrix phase reads fall in distinct banks
__device__ __forceinline__ int code_off(int row, int u) {
  return row * (kKC / 2) + ((u ^ (row & 7)) << 4);
}

struct Problem {
  const __nv_bfloat16* x;
  const int32_t* packed;
  const float *S, *Z, *dinv;
  __nv_bfloat16* y;
  long long x_stride;                     // per expert: T·d, or 0 (shared)
  int E, T, dp, d, g, gshift;
  int row_tiles, token_tiles, chunks, items;
  int sz_vec;                             // floats per S/Z copy: 1, 2 or 4
  int sz_shift;                           // log2 of a row's S/Z copies a stage
};

// an item: kRows rows of expert e from r0, tokens t0 .. t0 + kTokens - 1
struct Item {
  int e, r0, t0;
};

__device__ __forceinline__ Item item_at(const Problem& p, int it) {
  Item w;
  w.t0 = (it % p.token_tiles) * kTokens;
  it /= p.token_tiles;
  w.r0 = (it % p.row_tiles) * kRows;
  w.e = it / p.row_tiles;
  return w;
}

// NT: n-tiles of 4 tokens (1-4).  GU: 32-k units per group, min(g, kKC)/32
// (1, 2, 4 or 8; at 8 a group ends where (k0 + kKC) % g == 0).  COPIES:
// the copy ring alone, no products and no conversion (y gets zeros), to
// measure what the copies reach of the byte bound.
//
// Step s of a block: wait until stage s + 1 has landed; one barrier; issue
// the copies of step s + kStages - 1 into the slot step s - 1 freed; the
// products of step s on its codes and on pair buffer s % 2; then convert
// stage s + 1's x chunk into pair buffer (s + 1) % 2.  One barrier a step,
// and a warp's conversion overlaps the other warps' products.
template <int NT, int GU, bool COPIES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    experts_mma_kernel(Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const pairs = smem + kStages * stage_bytes(NT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lg = lane >> 2, lt = lane & 3;
  const int n_my = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  const int n_steps = n_my * p.chunks;
  const int wpr = p.d / 8;                // code words per row
  const int gpr = p.d >> p.gshift;        // groups per row

  // the copy cursor: the next step to load
  int l_item = blockIdx.x, l_chunk = 0;
  Item li = item_at(p, l_item);
  auto load_next = [&](int slot) {
    const uint32_t sc = smem_addr(smem + slot * stage_bytes(NT));
    const uint32_t sS = sc + codes_bytes(), sZ = sS + sz_bytes();
    const uint32_t sx = sZ + sz_bytes(), sd = sx + x_bytes(NT);
    const int k0 = l_chunk * kKC;
    const int nu = min(kUnits, (p.d - k0) >> 5);
    const size_t erow = (size_t)li.e * p.dp;
    // codes: 64 rows × nu 16-byte units
#pragma unroll
    for (int h = 0; h < kRows * kUnits / kThreads; ++h) {
      const int i = threadIdx.x + h * kThreads;
      const int row = i / kUnits, u = i % kUnits;
      const int gr = min(li.r0 + row, p.dp - 1);
      cp_async<16>(sc + code_off(row, u),
                   p.packed + (erow + gr) * wpr + (k0 >> 3) + u * 4,
                   li.r0 + row < p.dp && u < nu);
    }
    // S and Z: each row's groups of the chunk (one group when g >= kKC)
    const int ngc = p.g >= kKC ? 1 : min(kKC, p.d - k0) >> p.gshift;
    const int per = 1 << p.sz_shift;
    for (int i = threadIdx.x; i < 2 * kRows * per; i += kThreads) {
      const int which = i >> p.sz_shift >> 6;       // kRows = 64
      const int row = (i >> p.sz_shift) & (kRows - 1), v = i & (per - 1);
      const int gr = min(li.r0 + row, p.dp - 1);
      const float* src = (which ? p.Z : p.S) + (erow + gr) * gpr +
                         (k0 >> p.gshift) + v * p.sz_vec;
      const uint32_t dst =
          (which ? sZ : sS) + row * kUnits * 4 + v * p.sz_vec * 4;
      const bool on = li.r0 + row < p.dp && v * p.sz_vec < ngc;
      if (p.sz_vec == 4) cp_async<16>(dst, src, on);
      else if (p.sz_vec == 2) cp_async<8>(dst, src, on);
      else cp_async<4>(dst, src, on);
    }
    // the chunk of the item's tokens (zeros past T), then of D⁻¹
    constexpr int nx = NT * 4 * (kKC / 8);
    for (int i = threadIdx.x; i < nx + kKC / 4; i += kThreads) {
      if (i < nx) {
        const int tt = i / (kKC / 8), c = i % (kKC / 8);
        const int t = min(li.t0 + tt, p.T - 1);
        cp_async<16>(sx + i * 16,
                     p.x + li.e * p.x_stride + (size_t)t * p.d + k0 + c * 8,
                     li.t0 + tt < p.T && c < 4 * nu);
      } else if (p.dinv != nullptr) {
        const int c = i - nx;
        cp_async<16>(sd + c * 16, p.dinv + (size_t)li.e * p.d + k0 + c * 4,
                     c < 8 * nu);
      }
    }
    if (++l_chunk == p.chunks) {
      l_chunk = 0;
      l_item += gridDim.x;
      if (l_item < p.items) li = item_at(p, l_item);
    }
  };

  // a stage's x chunk → pair buffer b: one (token, 8 consecutive k) per
  // thread, a warp per token; per 32-k unit and column the bf16 pairs of
  // hi (columns 0-3) and lo (4-7) in mma order, and Σ(hi + lo) of the unit
  // on the hi column (0 on the lo column: the z term is counted once)
  auto convert = [&](int slot, int b) {
    const unsigned char* st = smem + slot * stage_bytes(NT);
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(
        st + codes_bytes() + 2 * sz_bytes());
    const float* sd = reinterpret_cast<const float*>(
        st + codes_bytes() + 2 * sz_bytes() + x_bytes(NT));
    uint4* xt = reinterpret_cast<uint4*>(pairs + b * pair_bytes(NT));
    float* xs =
        reinterpret_cast<float*>(pairs + b * pair_bytes(NT) + xt_bytes(NT));
#pragma unroll
    for (int q = threadIdx.x; q < NT * 4 * (kKC / 8); q += kThreads) {
      const int tt = q / (kKC / 8), o = q % (kKC / 8);
      const int u = o >> 2, t = o & 3;
      float v[8];
      {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(sx + tt * kKC + o * 8);
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
      uint32_t hw[4], lw[4];
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {           // the pair (k, k + 4)
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[k], v[k + 4]);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 l =
            __floats2bfloat162_rn(v[k] - hf.x, v[k + 4] - hf.y);
        const float2 lf = __bfloat1622float2(l);
        hw[k] = as_u32(h);
        lw[k] = as_u32(l);
        sum += (hf.x + lf.x) + (hf.y + lf.y);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int ch = (tt >> 2) * 8 + (tt & 3), cl = ch + 4;
      xt[(u * NT * 8 + ch) * 4 + t] = make_uint4(hw[0], hw[1], hw[2], hw[3]);
      xt[(u * NT * 8 + cl) * 4 + t] = make_uint4(lw[0], lw[1], lw[2], lw[3]);
      if (t == 0) {
        xs[u * NT * 8 + ch] = sum;
        xs[u * NT * 8 + cl] = 0.0f;
      }
    }
  };

  // out: f32 sums of this lane's rows (g, g + 8) × columns (2t, 2t + 1) per
  // n-tile; acc: the current group's products; xg: its x̃ sums (GU > 1)
  float out[NT][4], acc[NT][4], xg[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[j][c] = acc[j][c] = 0.0f;
    xg[j][0] = xg[j][1] = 0.0f;
  }

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_next(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  if (n_steps > 0 && !COPIES) convert(0, 0);

  // the compute cursor
  int c_item = blockIdx.x, c_chunk = 0;
  Item ci = item_at(p, c_item);
  const int rw = warp * 16 + lg;          // this lane's first row in the item
  // ldmatrix rows: lanes 8m..8m+7 give matrix m's rows: rows 0-7 (m even)
  // or 8-15 (m odd) of the warp's tile, unit up (m < 2) or up + 1
  const int lrow = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lunit = lane >> 4;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 3>();
    __syncthreads();       // stage s + 1 landed, pairs s written; the slot
                           // of step s - 1 and pair buffer (s + 1) % 2 free
    if (s + kStages - 1 < n_steps) load_next((s + kStages - 1) % kStages);
    cp_async_commit();

    const unsigned char* st = smem + (s % kStages) * stage_bytes(NT);
    const float* sS = reinterpret_cast<const float*>(st + codes_bytes());
    const float* sZ = sS + sz_bytes() / 4;
    const unsigned char* pb = pairs + (s & 1) * pair_bytes(NT);
    const uint4* xtv = reinterpret_cast<const uint4*>(pb);
    const float* xs = reinterpret_cast<const float*>(pb + xt_bytes(NT));
    const int k0 = c_chunk * kKC;
    const int nu = min(kUnits, (p.d - k0) >> 5);
    const uint32_t codes = smem_addr(st);
    const bool group_at_end = GU < kUnits || ((k0 + kKC) & (p.g - 1)) == 0;
    // y = Σ_groups s·Σ c·x̃ + z·Σ x̃: a group's products and x̃ sum, then
    // its s and z
    auto fold = [&](int gi, const float (&xsum)[NT][2]) {
      const float4 s0 = *reinterpret_cast<const float4*>(
          sS + rw * kUnits + (gi & ~3));
      const float4 s1 = *reinterpret_cast<const float4*>(
          sS + (rw + 8) * kUnits + (gi & ~3));
      const float4 z0 = *reinterpret_cast<const float4*>(
          sZ + rw * kUnits + (gi & ~3));
      const float4 z1 = *reinterpret_cast<const float4*>(
          sZ + (rw + 8) * kUnits + (gi & ~3));
      const int c4 = gi & 3;
      const float sr[2] = {c4 == 0 ? s0.x : c4 == 1 ? s0.y : c4 == 2 ? s0.z
                                                                      : s0.w,
                           c4 == 0 ? s1.x : c4 == 1 ? s1.y : c4 == 2 ? s1.z
                                                                      : s1.w};
      const float zr[2] = {c4 == 0 ? z0.x : c4 == 1 ? z0.y : c4 == 2 ? z0.z
                                                                      : z0.w,
                           c4 == 0 ? z1.x : c4 == 1 ? z1.y : c4 == 2 ? z1.z
                                                                      : z1.w};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1;
          out[j][c] = fmaf(sr[r], acc[j][c], out[j][c]);
          out[j][c] = fmaf(zr[r], xsum[j][c & 1], out[j][c]);
          acc[j][c] = 0.0f;
        }
    };
#pragma unroll
    for (int up = 0; up < kUnits; up += 2) {
      if (up >= nu || COPIES) break;
      uint32_t w[4];
      ldmatrix_x4(w, codes + code_off(lrow, up + lunit));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = up + h;
        if (u >= nu) break;
        const uint32_t q0 = w[h * 2], q1 = w[h * 2 + 1];   // rows g, g+8
        const uint32_t a0[4] = {deq2(q0), deq2(q1), deq2(q0 >> 4),
                                deq2(q1 >> 4)};
        const uint32_t a1[4] = {deq2(q0 >> 8), deq2(q1 >> 8), deq2(q0 >> 12),
                                deq2(q1 >> 12)};
        float xu[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint4 b = xtv[(u * NT * 8 + j * 8 + lg) * 4 + lt];
          mma_bf16(acc[j], a0, b.x, b.y);
          mma_bf16(acc[j], a1, b.z, b.w);
          const float2 xsum = *reinterpret_cast<const float2*>(
              xs + u * NT * 8 + j * 8 + 2 * lt);
          xu[j][0] = xsum.x;
          xu[j][1] = xsum.y;
        }
        if constexpr (GU == 1) {
          fold(u, xu);
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            xg[j][0] += xu[j][0];
            xg[j][1] += xu[j][1];
          }
          if ((u + 1) % GU == 0 && (GU < kUnits || group_at_end)) {
            fold(GU < kUnits ? u / GU : 0, xg);
#pragma unroll
            for (int j = 0; j < NT; ++j) xg[j][0] = xg[j][1] = 0.0f;
          }
        }
      }
    }

    if (c_chunk == p.chunks - 1) {        // the item's last chunk: store
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // lanes t and t^2 hold hi and lo of the same two tokens
          const float v =
              out[j][c] + __shfl_xor_sync(0xffffffffu, out[j][c], 2);
          const int tok = ci.t0 + j * 4 + 2 * lt + (c & 1);
          const int row = ci.r0 + rw + (c >> 1) * 8;
          if (lt < 2 && tok < p.T && row < p.dp)
            p.y[((size_t)ci.e * p.T + tok) * p.dp + row] =
                __float2bfloat16_rn(v);
          out[j][c] = 0.0f;
        }
      }
      c_chunk = 0;
      c_item += gridDim.x;
      if (c_item < p.items) ci = item_at(p, c_item);
    } else {
      ++c_chunk;
    }
    if (s + 1 < n_steps && !COPIES) convert((s + 1) % kStages, (s + 1) & 1);
  }
  cp_async_wait<0>();
}

// the grid: as many blocks as fit on the card at once (at most one per
// item); each walks items b, b + grid, ...
template <int NT, int GU, bool COPIES>
int launch(const Problem& p, int n_sm, cudaStream_t stream) {
  auto kern = experts_mma_kernel<NT, GU, COPIES>;
  constexpr int smem = smem_bytes(NT);
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                        smem);
    if (e != cudaSuccess) return (int)e;
    per_sm = n > 0 ? n : 1;
  }
  const long long fit = (long long)per_sm * n_sm;
  const int blocks = (int)(p.items < fit ? p.items : fit);
  kern<<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NT, bool COPIES>
int by_group(const Problem& p, int n_sm, cudaStream_t stream) {
  if (p.g == 32) return launch<NT, 1, COPIES>(p, n_sm, stream);
  if (p.g == 64) return launch<NT, 2, COPIES>(p, n_sm, stream);
  if (p.g == 128) return launch<NT, 4, COPIES>(p, n_sm, stream);
  return launch<NT, 8, COPIES>(p, n_sm, stream);
}

template <bool COPIES>
int run(const void* x, int x_shared, const int32_t* packed, const float* S,
        const float* Z, const float* dinv, void* y, int E, int T, int dp,
        int d, int g, int n_sm, void* stream_ptr) {
  if (E <= 0 || T <= 0 || dp <= 0 || d <= 0 || n_sm <= 0 || g < 32 ||
      (g & (g - 1)) || d % g)
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.packed = packed;
  p.S = S;
  p.Z = Z;
  p.dinv = dinv;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.x_stride = x_shared ? 0 : (long long)T * d;
  p.E = E;
  p.T = T;
  p.dp = dp;
  p.d = d;
  p.g = g;
  p.gshift = 0;
  while ((1 << p.gshift) < g) ++p.gshift;
  p.row_tiles = (dp + kRows - 1) / kRows;
  p.token_tiles = (T + kTokens - 1) / kTokens;
  p.chunks = (d + kKC - 1) / kKC;
  p.items = E * p.row_tiles * p.token_tiles;
  // the widest S/Z copy that every chunk's run of groups and every row's
  // start (d/g floats apart) allow
  const int ngc = g >= kKC ? 1 : kKC / g, gpr = d / g;
  p.sz_vec = 1;
  for (int v = 4; v > 1; v >>= 1)
    if (ngc % v == 0 && gpr % v == 0) {
      p.sz_vec = v;
      break;
    }
  p.sz_shift = 0;
  while ((p.sz_vec << p.sz_shift) < ngc) ++p.sz_shift;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int tt = T < kTokens ? T : kTokens;
  if constexpr (COPIES) {                 // measured at the served shape only
    if (tt > 4 || g != 32) return (int)cudaErrorInvalidValue;
    return launch<1, 1, true>(p, n_sm, stream);
  }
  if (tt <= 4) return by_group<1, COPIES>(p, n_sm, stream);
  if (tt <= 8) return by_group<2, COPIES>(p, n_sm, stream);
  if (tt <= 12) return by_group<3, COPIES>(p, n_sm, stream);
  return by_group<4, COPIES>(p, n_sm, stream);
}

}  // namespace

// E experts in one launch on tensor cores: x (E, T, d) bf16, or (T, d) shared
// by every expert when x_shared; packed (E, d', d/8) int32 of int4 codes; S, Z
// (E, d', d/g) f32 with g a power of two >= 32; dinv (E, d) f32 or null;
// y (E, T, d') bf16.  All contiguous and 16-byte aligned.  n_sm: the card's
// SM count (the persistent grid is as many blocks as fit on it).
extern "C" int ttq_gemm_experts_mma_launch(
    const void* x, int x_shared, const int32_t* packed, const float* S,
    const float* Z, const float* dinv, void* y, int E, int T, int dp, int d,
    int g, int n_sm, void* stream_ptr) {
  return run<false>(x, x_shared, packed, S, Z, dinv, y, E, T, dp, d, g, n_sm,
                    stream_ptr);
}

// The same launch's copy ring alone, at T <= 4 and g = 32 (the served
// shape): every copy of the tile, no products and no conversion; y gets
// zeros.  What the copies reach of the byte bound (tools/experts_probe.py);
// no wrapper calls it.
extern "C" int ttq_gemm_experts_mma_copies_launch(
    const void* x, int x_shared, const int32_t* packed, const float* S,
    const float* Z, const float* dinv, void* y, int E, int T, int dp, int d,
    int g, int n_sm, void* stream_ptr) {
  return run<true>(x, x_shared, packed, S, Z, dinv, y, E, T, dp, d, g, n_sm,
                   stream_ptr);
}
