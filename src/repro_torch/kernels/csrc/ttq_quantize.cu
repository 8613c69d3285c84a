// ttq_quantize — online scaled groupwise quantize + pack, one streaming pass.
//
// Replaces: src/repro/kernels/ttq_quantize.py:ttq_quantize (Pallas body
// _quant_kernel).  Computes, per row and per group of g along d:
//   w = W∘D (f32), s = max((max-min)/qmax, 1e-12), z = min,
//   code = clip(round_half_even((w - z) / s), 0, qmax), packed 32/bits per
//   int32, low bits first (bits = 8 stores the uint32 bit pattern, so a code
//   >= 128 in the top byte wraps into the sign bit like the reference sum).
//
// Bound on the card: bytes.  It reads each bf16 weight once (2 B) and writes
// bits/8 B of codes plus 8 B of scale/zero per group; there is almost no
// arithmetic per byte.  Design: each thread owns E consecutive elements of a
// row (E = max(32/bits, g/32)), loads them with vector loads, applies D in
// f32, and the g/E threads of a group exchange min/max with warp shuffles,
// so a group never leaves registers.  Consecutive threads own consecutive
// elements, so every load and store is coalesced.  The batch dimension n (a
// layer stack of one weight family) is the grid's y axis: a whole stack is
// one launch and is read in place, never copied to f32.
//
// Exactness: the multiply and the subtraction use __fmul_rn/__fsub_rn so
// the compiler cannot contract them into an FMA, the division is
// __fdiv_rn and the rounding rintf (half to even), never roundf.
#include "common.cuh"

namespace {

template <int BITS, int E, typename T>
__global__ void __launch_bounds__(256) quant_kernel(
    const T* __restrict__ W, const float* __restrict__ D,
    int32_t* __restrict__ packed, float* __restrict__ S, float* __restrict__ Z,
    int dp, int d, int g) {
  constexpr int PER = 32 / BITS;
  constexpr int NW = E / PER;
  const float qmax = (float)((1 << BITS) - 1);
  const int n = blockIdx.y;
  const long long per_row = d / E;
  const long long total = (long long)dp * per_row;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t < total;
  // lanes past the end form whole groups of their own (total is a multiple
  // of the group's thread count), so they may compute on row 0 unseen
  const long long tt = active ? t : 0;
  const long long row = tt / per_row;
  const int col0 = (int)(tt % per_row) * E;

  const T* wrow = W + ((long long)n * dp + row) * d + col0;
  const float* Dn = D + (long long)n * d + col0;
  float w[E];
#pragma unroll
  for (int c = 0; c < E / 4; ++c) {
    float wv[4], dv[4];
    ttq::load4(wrow + 4 * c, wv);
    ttq::load4(Dn + 4 * c, dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[4 * c + e] = __fmul_rn(wv[e], dv[e]);
  }
  float mx = w[0], mn = w[0];
#pragma unroll
  for (int i = 1; i < E; ++i) { mx = fmaxf(mx, w[i]); mn = fminf(mn, w[i]); }
  const int tpg = g / E;  // threads per group: a power of two <= 32
  for (int off = 1; off < tpg; off <<= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
  float s = fmaxf(__fdiv_rn(__fsub_rn(mx, mn), qmax), 1e-12f);
  const float z = mn;
  uint32_t words[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) words[j] = 0u;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float c = rintf(__fdiv_rn(__fsub_rn(w[i], z), s));
    c = fminf(fmaxf(c, 0.0f), qmax);
    words[i / PER] |= ((uint32_t)c) << ((i % PER) * BITS);
  }
  if (!active) return;
  const long long rbase = (long long)n * dp + row;
  int32_t* prow = packed + rbase * (d / PER) + col0 / PER;
#pragma unroll
  for (int j = 0; j < NW; ++j) prow[j] = (int32_t)words[j];
  if ((threadIdx.x & (tpg - 1)) == 0) {
    const long long gi = rbase * (d / g) + col0 / g;
    S[gi] = s;
    Z[gi] = z;
  }
}

template <int BITS, int E>
void launch(const void* W, int w_bf16, const float* D, int32_t* packed,
            float* S, float* Z, int n, int dp, int d, int g,
            cudaStream_t stream) {
  const long long total = (long long)dp * (d / E);
  dim3 block(256), grid((unsigned)((total + 255) / 256), n);
  if (w_bf16)
    quant_kernel<BITS, E, __nv_bfloat16><<<grid, block, 0, stream>>>(
        (const __nv_bfloat16*)W, D, packed, S, Z, dp, d, g);
  else
    quant_kernel<BITS, E, float><<<grid, block, 0, stream>>>(
        (const float*)W, D, packed, S, Z, dp, d, g);
}

}  // namespace

extern "C" int ttq_quantize_launch(const void* W, int w_bf16, const float* D,
                                   int32_t* packed, float* S, float* Z, int n,
                                   int dp, int d, int bits, int g,
                                   void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int per = 32 / bits;
  const int E = per > g / 32 ? per : g / 32;
  if (n <= 0 || dp <= 0 || d % g || g % E) return (int)cudaErrorInvalidValue;
#define TTQ_Q(B, EE) \
  if (bits == B && E == EE) { launch<B, EE>(W, w_bf16, D, packed, S, Z, n, dp, d, g, stream); return (int)cudaGetLastError(); }
  TTQ_Q(2, 16)
  TTQ_Q(4, 8) TTQ_Q(4, 16)
  TTQ_Q(8, 4) TTQ_Q(8, 8) TTQ_Q(8, 16)
#undef TTQ_Q
  return (int)cudaErrorInvalidValue;
}
