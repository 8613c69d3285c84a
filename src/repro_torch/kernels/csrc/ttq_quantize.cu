// ttq_quantize — online scaled group-wise quantize + pack, one streaming pass.
//
// Replaces: src/repro/kernels/ttq_quantize.py:_quant_kernel (pallas_call at
// :66).  Computes, per row and per group of g along d:
//   w = W∘D (f32), s = max((max-min)/qmax, 1e-12), z = min,
//   code = clip(round_half_even((w - z) / s), 0, qmax), packed 32/bits per
//   int32, low bits first (bits = 8 stores the uint32 bit pattern, so a code
//   >= 128 in the top byte wraps into the sign bit like the reference sum);
//   S and Z (n, d', d/g) f32.  W is a (n, d', d) bf16 or f32 layer stack,
//   read in place; D is (n, d) f32.
//
// Bound on the card: bytes.  Each weight is read once (2 B in bf16) and
// bits/8 B of codes plus 8 B of S/Z per group are written: at gemma-7b's
// int4 g32 families that is 2.75 B per element, 6.364 ms per requant at
// 3.35 TB/s.  On an H100 80GB HBM3 at 700 W this kernel reaches 77-85% of
// that bound per family (chip_smoke.py [2]).  The design keeps the issue
// slots per element under the memory time and rows of loads in flight:
//
// * Long-lived warps that walk rows.  A strip is 2 KB of one row of W: a
//   lane owns kVecs = 4 16-byte vectors of it (V = 8 bf16 or 4 f32
//   elements each), vector c of lane l at 16·(32c + l) bytes, so each load
//   instruction of a warp reads 512 adjacent bytes.  The stack's (layer,
//   strip, row) items are split evenly over the grid's warps, each warp a
//   contiguous run down the rows of a strip.  The grid is the blocks the
//   card holds at once (kernels/ttq_quantize.py:quant_blocks).
// * D once per strip: a lane's 4·V values of D sit in registers while its
//   warp walks the strip, with the row pointers of the outputs, which then
//   step by one row: no division, no 64-bit multiply per row.
// * Loads in flight: each warp keeps a ring of kStages rows in shared
//   memory, filled by cp.async (16 bytes a lane, L1 bypassed), so 3 rows
//   (6 KB per warp) are in flight while it computes one; a lane reads back
//   only its own slots, so the ring needs no barrier.
// * No division and no float-to-int conversion per element.  Per group
//   r = 1/s (one rounded reciprocal); per element q = (w - z)·r, then
//   q + 1.5·2^23 rounds half to even in the default rounding mode, and the
//   low mantissa bits of that float are the code, added into the packed
//   word by an integer multiply-add (the magic exponent bits of a word are
//   one constant, subtracted once per word).  The quotient the reference
//   takes, rn((w - z)/s), and q differ by at most 3·(qmax+1)·2^-24; only
//   where q lies within tau = (qmax+1)·2^-22 of a half-integer can the two
//   round to different integers, so a lane that finds such a q in its row
//   recomputes that row's codes with __fdiv_rn, and every code is the
//   plain version's, bit for bit.  q <= qmax·(1 + 2^-22) < qmax + 1/2 and
//   q >= 0 for finite inputs, so no clamp is needed on the common path; a
//   group with a NaN or infinite range (s is NaN or > 2^125) takes the exact
//   path too.
// * s as the plain version computes it on the card: PyTorch's CUDA division
//   of a tensor by a Python scalar multiplies by the scalar's rounded
//   reciprocal, so s = rn((max - min)·rn(1/qmax)).  max and min propagate
//   NaN, as torch.amax/amin do.
// * Stores: a lane's codes of one vector are V·bits/32 words, one 4- or
//   8-byte store, so a warp writes 128-256 adjacent bytes per store; below
//   a word (bits 2 bf16, bits 2 and 4 f32) adjacent lanes combine their
//   bits with shuffles first.  A 16-byte code store would need 32/bits·4
//   adjacent codes per lane, i.e. lanes that do not read adjacent
//   addresses.  S and Z: one lane per group, a warp's values adjacent.
//
// Other group sizes: the walk above needs g a power of two in [32/bits,
// 512].  Every other (d, g, bits) with whole groups and code words (the
// reference's Pallas kernel takes d <= 512, or a block of 512 columns, with
// g and 32/bits dividing the block) runs quant_generic: one block per row,
// one thread per group for its min and max (S and Z, written to device
// memory), a barrier, then one thread per code word, each code by the
// plain version's quotient __fdiv_rn.  Right, not fast: no served shape
// runs it.
//
// Exactness: the multiply by D, the subtraction and the scale use
// __fmul_rn/__fsub_rn so the compiler cannot contract them into an FMA, and
// the build takes no --use_fast_math (kernels/build.py).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;              // warps per block; each walks alone
constexpr int kMinBlocksPerSm = 2;     // the grid rule's residency (<= 128 regs)
constexpr int kStages = 4;             // rows in each warp's shared ring
constexpr int kVecs = 4;               // 16-byte vectors per lane and row
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23: ulp 1 over [2^23, 2^24)
constexpr uint32_t kMagicBits = 0x4B400000u;

template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {   // 8 elements per 16 bytes
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(x[i] << 16);
      f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<float> {           // 4 elements per 16 bytes
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 16 bytes global → shared, bypassing L1; zero-filled where !ok
__device__ __forceinline__ void cp_async16(uint4* smem, const void* gmem,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the magic exponent bits that N codes of BITS bits leave in one word
template <int BITS, int N>
__host__ __device__ constexpr uint32_t magic_sum() {
  uint32_t k = 0;
  for (int i = 0; i < N; ++i) k += kMagicBits << (BITS * i);
  return k;
}

// BITS: code width; GPC: groups per 16-byte vector (2 when a group is half
// a vector: bf16 at g = 4); CPG: vectors per group and lane (> 1 when a
// group is wider than a warp's 32 vectors: it spans CPG of a lane's kVecs).
template <int BITS, int GPC, int CPG, typename T>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocksPerSm) quant_kernel(
    const T* __restrict__ W, const float* __restrict__ D,
    int32_t* __restrict__ packed, float* __restrict__ S, float* __restrict__ Z,
    int dp, int d, int g, int strips, long long items) {
  constexpr int V = Vec<T>::V;
  constexpr int E = kVecs * V;               // elements per lane and row
  constexpr int NG = kVecs * GPC / CPG;      // groups a lane holds per row
  constexpr int GE = E / NG;                 // elements of each it holds
  constexpr int PER = 32 / BITS;             // codes per word
  constexpr int NB = V * BITS;               // code bits of one vector
  constexpr int WPV = NB >= 32 ? NB / 32 : 1;   // words per vector
  constexpr int CPW = NB >= 32 ? PER : V;       // codes in one of those words
  constexpr int LPW = NB >= 32 ? 1 : 32 / NB;   // lanes that share a word
  constexpr int SW = 32 * E;                 // strip width, columns
  constexpr float kQmax = (float)((1 << BITS) - 1);
  constexpr float kInvQmax = 1.0f / kQmax;   // rn(1/qmax), as PyTorch's
  constexpr float kTie = 0.5f - (float)(1 << BITS) * 0x1p-22f;
  constexpr uint32_t kWordMagic = magic_sum<BITS, CPW>();

  const int lane = threadIdx.x & 31;
  const int L = CPG > 1 ? 32 : GPC == 2 ? 1 : g / V;   // lanes per group
  const bool leader = (lane & (L - 1)) == 0; // the lane that stores S and Z
  const int lg = 31 - __clz(g);              // g is a power of two
  const long long nw = (long long)gridDim.x * kWarps;
  const long long wid = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  long long it = wid * items / nw;           // items: (layer, strip, row)
  const long long end = (wid + 1) * items / nw;
  if (it >= end) return;                     // warp-uniform

  const int ngr = d / g, nwords = d / PER;
  const long long unit = it / dp;
  int layer = (int)(unit / strips), strip = (int)(unit % strips);
  int row = (int)(it - unit * dp);
  // which of a lane's vectors lie inside d (all but in a ragged last strip)
  auto in_d = [&](int st) {
    unsigned m = 0u;
#pragma unroll
    for (int c = 0; c < kVecs; ++c)
      m |= (st * SW + c * 32 * V + lane * V < d ? 1u : 0u) << c;
    return m;
  };

  float dv[E];
  unsigned mask = 0u;
  int32_t* pp;                               // this lane's row of codes,
  float *sp, *zp;                            // S and Z
  auto enter = [&]() {                       // a new strip: D, mask, pointers
    mask = in_d(strip);
    const long long rw = (long long)layer * dp + row;
    const int col = strip * SW + lane * V;
    pp = packed + rw * nwords + col / PER;
    sp = S + rw * ngr + (col >> lg);
    zp = Z + rw * ngr + (col >> lg);
    const float* dl = D + (long long)layer * d + strip * SW + lane * V;
#pragma unroll
    for (int c = 0; c < kVecs; ++c) {
      if ((mask >> c) & 1u) {
        ttq::load4(dl + c * 32 * V, dv + c * V);
        if constexpr (V == 8) ttq::load4(dl + c * 32 * V + 4, dv + c * V + 4);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) dv[c * V + e] = 0.0f;
      }
    }
  };

  // the warp's ring: kStages rows of kVecs vectors per lane, each lane's own
  // 16-byte slots (it reads back only what it copied)
  extern __shared__ uint4 ring[];
  uint4* mine = ring + (threadIdx.x >> 5) * (kStages * kVecs * 32) + lane;
  int ll = layer, ls = strip, lr = row;      // the next row to copy
  unsigned lmask = in_d(ls);
  const T* lp = W + ((long long)ll * dp + lr) * d + ls * SW + lane * V;
  long long lit = it;
  auto issue = [&](int slot) {
    if (lit < end) {
#pragma unroll
      for (int c = 0; c < kVecs; ++c) {
        cp_async16(mine + (slot * kVecs + c) * 32, lp + c * 32 * V,
                   (lmask >> c) & 1u);
      }
      if (++lr < dp) {
        lp += d;
      } else {
        lr = 0;
        if (++ls == strips) { ls = 0; ++ll; }
        lmask = in_d(ls);
        lp = W + (long long)ll * dp * d + ls * SW + lane * V;
      }
    }
    ++lit;
    cp_async_commit();                       // one group per row, even empty
  };

  auto compute = [&](const uint4 (&buf)[kVecs]) {
    float w[E], z[NG], s[NG], rc[NG];
#pragma unroll
    for (int c = 0; c < kVecs; ++c) Vec<T>::unpack(buf[c], w + c * V);
#pragma unroll
    for (int e = 0; e < E; ++e) w[e] = __fmul_rn(w[e], dv[e]);
#pragma unroll
    for (int h = 0; h < NG; ++h) {
      float mn = w[h * GE], mx = mn;
#pragma unroll
      for (int e = 1; e < GE; ++e) {
        mn = min_nan(mn, w[h * GE + e]);
        mx = max_nan(mx, w[h * GE + e]);
      }
      z[h] = mn;
      s[h] = mx;                             // the group's max, for now
    }
    for (int off = 1; off < L; off <<= 1) {
#pragma unroll
      for (int h = 0; h < NG; ++h) {
        z[h] = min_nan(z[h], __shfl_xor_sync(0xffffffffu, z[h], off));
        s[h] = max_nan(s[h], __shfl_xor_sync(0xffffffffu, s[h], off));
      }
    }
    bool slow = false;
#pragma unroll
    for (int h = 0; h < NG; ++h) {
      s[h] = max_nan(__fmul_rn(__fsub_rn(s[h], z[h]), kInvQmax), 1e-12f);
      rc[h] = __frcp_rn(s[h]);
      slow |= !(s[h] <= 0x1p125f);           // NaN, inf, or 1/s subnormal
    }
    uint32_t words[kVecs][WPV];
    float emax = 0.0f;
#pragma unroll
    for (int c = 0; c < kVecs; ++c) {
#pragma unroll
      for (int j = 0; j < WPV; ++j) {
        uint32_t acc = 0u;
#pragma unroll
        for (int i = 0; i < CPW; ++i) {
          const int e = c * V + j * CPW + i, h = e / GE;
          const float q = __fmul_rn(__fsub_rn(w[e], z[h]), rc[h]);
          const float f = __fadd_rn(q, kMagic);
          emax = fmaxf(emax, fabsf(__fsub_rn(q, __fsub_rn(f, kMagic))));
          acc += __float_as_uint(f) << (BITS * i);
        }
        words[c][j] = acc - kWordMagic;
      }
    }
    if (slow || emax >= kTie) {              // rare: the reference's quotient
#pragma unroll
      for (int c = 0; c < kVecs; ++c) {
#pragma unroll
        for (int j = 0; j < WPV; ++j) {
          uint32_t acc = 0u;
#pragma unroll
          for (int i = 0; i < CPW; ++i) {
            const int e = c * V + j * CPW + i, h = e / GE;
            const float q = fminf(fmaxf(__fdiv_rn(__fsub_rn(w[e], z[h]), s[h]),
                                        0.0f), kQmax);
            acc += __float_as_uint(__fadd_rn(q, kMagic)) << (BITS * i);
          }
          words[c][j] = acc - kWordMagic;
        }
      }
    }
    if constexpr (LPW > 1) {                 // below a word: gather lanes
#pragma unroll
      for (int c = 0; c < kVecs; ++c) {
        uint32_t v = words[c][0];
#pragma unroll
        for (int k = 1; k < LPW; ++k)
          v |= __shfl_down_sync(0xffffffffu, words[c][0], k) << (k * NB);
        words[c][0] = v;
      }
    }
#pragma unroll
    for (int c = 0; c < kVecs; ++c) {
      if (!((mask >> c) & 1u)) continue;     // past a ragged strip's end
      const int gc = (c * 32 * V) >> lg;     // the vector's group, from sp
      if constexpr (WPV == 2)
        *reinterpret_cast<int2*>(pp + c * 32 * V / PER) =
            make_int2((int)words[c][0], (int)words[c][WPV - 1]);
      else if (lane % LPW == 0)
        pp[c * 32 * V / PER] = (int)words[c][0];
      if constexpr (GPC == 2) {
        *reinterpret_cast<float2*>(sp + gc) =
            make_float2(s[2 * c], s[2 * c + GPC - 1]);
        *reinterpret_cast<float2*>(zp + gc) =
            make_float2(z[2 * c], z[2 * c + GPC - 1]);
      } else if (c % CPG == 0 && leader) {
        sp[gc] = s[c / CPG];
        zp[gc] = z[c / CPG];
      }
    }
    pp += nwords;                            // the next row
    sp += ngr;
    zp += ngr;
  };

  enter();
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; it < end; ++it, ++k) {
    cp_async_wait<kStages - 2>();            // row k has landed
    const int slot = k % kStages;
    uint4 buf[kVecs];
#pragma unroll
    for (int c = 0; c < kVecs; ++c) buf[c] = mine[(slot * kVecs + c) * 32];
    issue((k + kStages - 1) % kStages);      // the slot read one row ago
    compute(buf);
    if (++row == dp) {
      row = 0;
      if (++strip == strips) { strip = 0; ++layer; }
      if (it + 1 < end) enter();
    }
  }
  cp_async_wait<0>();
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32(float v) { return v; }

// One block per (layer, row): see "Other group sizes" above.  S and Z are
// read back after the barrier, so they are not restrict-qualified.
template <int BITS, typename T>
__global__ void __launch_bounds__(128) quant_generic(
    const T* __restrict__ W, const float* __restrict__ D,
    int32_t* __restrict__ packed, float* S, float* Z, int dp, int d, int g) {
  constexpr int PER = 32 / BITS;
  constexpr float kQmax = (float)((1 << BITS) - 1);
  constexpr float kInvQmax = 1.0f / kQmax;
  const long long rw = blockIdx.x;            // layer · d' + row
  const int ngr = d / g, nwords = d / PER;
  const T* wr = W + rw * d;
  const float* dl = D + (rw / dp) * d;
  float* sr = S + rw * ngr;
  float* zr = Z + rw * ngr;
  for (int gi = threadIdx.x; gi < ngr; gi += blockDim.x) {
    float mn = __fmul_rn(to_f32(wr[gi * g]), dl[gi * g]), mx = mn;
    for (int j = 1; j < g; ++j) {
      const float w = __fmul_rn(to_f32(wr[gi * g + j]), dl[gi * g + j]);
      mn = min_nan(mn, w);
      mx = max_nan(mx, w);
    }
    sr[gi] = max_nan(__fmul_rn(__fsub_rn(mx, mn), kInvQmax), 1e-12f);
    zr[gi] = mn;
  }
  __syncthreads();
  for (int wi = threadIdx.x; wi < nwords; wi += blockDim.x) {
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = wi * PER + i, gi = k / g;
      const float w = __fmul_rn(to_f32(wr[k]), dl[k]);
      const float q = fminf(fmaxf(__fdiv_rn(__fsub_rn(w, zr[gi]), sr[gi]),
                                  0.0f), kQmax);
      acc |= (uint32_t)rintf(q) << (BITS * i);
    }
    packed[rw * nwords + wi] = (int32_t)acc;
  }
}

template <typename T>
int launch_generic(const T* W, const float* D, int32_t* packed, float* S,
                   float* Z, int n, int dp, int d, int bits, int g,
                   cudaStream_t stream) {
  const unsigned rows = (unsigned)n * (unsigned)dp;
#define TTQ_QG(B)                                                        \
  if (bits == B) {                                                       \
    quant_generic<B, T><<<rows, 128, 0, stream>>>(W, D, packed, S, Z, dp, \
                                                 d, g);                  \
    return (int)cudaGetLastError();                                      \
  }
  TTQ_QG(2) TTQ_QG(4) TTQ_QG(8)
#undef TTQ_QG
  return (int)cudaErrorInvalidValue;
}

template <int BITS, int GPC, int CPG, typename T>
int launch(const T* W, const float* D, int32_t* packed, float* S, float* Z,
           int n, int dp, int d, int g, int blocks, int strips,
           cudaStream_t stream) {
  const long long items = (long long)n * strips * dp;
  constexpr int smem = kWarps * kStages * kVecs * 32 * (int)sizeof(uint4);
  cudaFuncSetAttribute(quant_kernel<BITS, GPC, CPG, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  quant_kernel<BITS, GPC, CPG, T><<<blocks, kWarps * 32, smem, stream>>>(
      W, D, packed, S, Z, dp, d, g, strips, items);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* W, const float* D, int32_t* packed, float* S, float* Z,
             int n, int dp, int d, int bits, int g, int blocks, int strips,
             cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  constexpr int SW = 32 * kVecs * V;         // strip width, columns
  if (strips != (d + SW - 1) / SW)           // planned for another kVecs
    return (int)cudaErrorInvalidValue;
  const int GPC = g < V ? V / g : 1;
  const int CPG = g > 32 * V ? g / (32 * V) : 1;
#define TTQ_Q(B, GG, CC)                                                    \
  if (bits == B && GPC == GG && CPG == CC)                                  \
    return launch<B, GG, CC, T>(W, D, packed, S, Z, n, dp, d, g, blocks,    \
                                strips, stream);
  if constexpr (V == 8) {   // bf16: g in [32/bits, 512]
    TTQ_Q(8, 2, 1) TTQ_Q(8, 1, 1) TTQ_Q(8, 1, 2)
    TTQ_Q(4, 1, 1) TTQ_Q(4, 1, 2)
    TTQ_Q(2, 1, 1) TTQ_Q(2, 1, 2)
  } else {                  // f32
    TTQ_Q(8, 1, 1) TTQ_Q(8, 1, 2) TTQ_Q(8, 1, 4)
    TTQ_Q(4, 1, 1) TTQ_Q(4, 1, 2) TTQ_Q(4, 1, 4)
    TTQ_Q(2, 1, 1) TTQ_Q(2, 1, 2) TTQ_Q(2, 1, 4)
  }
#undef TTQ_Q
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ttq_quantize_launch(const void* W, int w_bf16, const float* D,
                                   int32_t* packed, float* S, float* Z, int n,
                                   int dp, int d, int bits, int g, int blocks,
                                   int warps, int blocks_per_sm, int strips,
                                   void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int V = w_bf16 ? 8 : 4;
  // the wrapper's grid rule (kernels/ttq_quantize.py) sizes the grid for
  // this geometry: refuse a launch planned for another one
  if (warps != kWarps || blocks_per_sm != kMinBlocksPerSm)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || dp <= 0 || blocks <= 0 || (bits != 2 && bits != 4 && bits != 8)
      || g <= 0 || d % g || d % (32 / bits))
    return (int)cudaErrorInvalidValue;
  if (g < 32 / bits || g > 512 || (g & (g - 1)) || d % V) {
    if (w_bf16)
      return launch_generic((const __nv_bfloat16*)W, D, packed, S, Z, n, dp,
                            d, bits, g, stream);
    return launch_generic((const float*)W, D, packed, S, Z, n, dp, d, bits, g,
                          stream);
  }
  if (w_bf16)
    return dispatch((const __nv_bfloat16*)W, D, packed, S, Z, n, dp, d, bits,
                    g, blocks, strips, stream);
  return dispatch((const float*)W, D, packed, S, Z, n, dp, d, bits, g, blocks,
                  strips, stream);
}
