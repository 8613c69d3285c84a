// ttq_gemm — fused dequant GEMM for the decode shape (T <= 16 tokens).
//
// Replaces: src/repro/kernels/ttq_gemm.py:ttq_gemm (Pallas body _gemm_kernel).
// Computes y (T, d') = (x∘D⁻¹)(T, d) · (code·s + z)ᵀ with codes unpacked from
// int32 words (32/bits per word, low bits first), per-(row, group) f32 scale
// s and zero z, f32 accumulation, output in x's dtype.
//
// Bound on the card: bytes.  At decode T is 1-16, so each weight byte feeds
// at most 2·T·(8/bits) flops, far below the ~295 flop/byte where the H100
// stops being memory bound; the time floor is packed codes + S/Z over
// 3.35 TB/s.  Design: every weight byte is read exactly once, as coalesced
// 16-byte loads.  A block of 4 warps owns 16 output rows (4 per warp); x∘D⁻¹
// is staged once per block in shared memory in f32, in chunks along d (a
// whole row of x at d = 24576, T = 4 would be 393 KB, over the 227 KB
// limit), so the D⁻¹ prologue costs nothing per weight.  Each lane streams
// uint4 words of its warp's 4 rows at once (4 loads in flight), unpacks
// them with shift/mask, dequantizes with each group's s and z, and
// multiplies against the staged x for all T tokens: every x value read from
// shared memory serves 4 rows, a quarter of the shared-memory traffic of one
// row at a time.  A warp-shuffle reduction closes each output.  The staged
// x is XOR-swizzled by 16-byte chunk so the lanes of a quarter-warp, which read
// addresses 128 B apart, hit distinct banks.  T > 16 runs more token tiles
// on the grid's y axis, so the kernel is right at every T.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kStageFloats = 8192;  // 32 KB of staged x per block

__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

template <int TT, int BITS, typename TX>
__global__ void __launch_bounds__(kWarps * 32) gemm_kernel(
    const TX* __restrict__ x, const int32_t* __restrict__ packed,
    const float* __restrict__ S, const float* __restrict__ Z,
    const float* __restrict__ dinv, TX* __restrict__ y, int T, int dp, int d,
    int g) {
  constexpr int R = kRowsPerWarp;
  constexpr int PER = 32 / BITS;
  constexpr int EPV = 4 * PER;            // elements per uint4 of codes
  constexpr int KC = kStageFloats / TT;   // staged chunk length along d
  constexpr int KC4 = KC / 4;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ float4 xs[kStageFloats / 4];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.y * TT;
  const int row0 = (blockIdx.x * kWarps + warp) * R;
  const int wpr = d / PER;                // int32 words per row
  const int gpr = d / g;
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) live[r] = row0 + r < dp;

  float acc[R][TT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[r][t] = 0.0f;

  for (int c0 = 0; c0 < d; c0 += KC) {
    const int clen = min(KC, d - c0);
    const int n4 = clen / 4;
    __syncthreads();                      // the previous chunk is consumed
    for (int i = threadIdx.x; i < TT * n4; i += blockDim.x) {
      const int t = i / n4, c = i - t * n4;
      const int k = c0 + 4 * c;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (t0 + t < T) {
        ttq::load4(x + (size_t)(t0 + t) * d + k, v);
        if (dinv != nullptr) {
          float dv[4];
          ttq::load4(dinv + k, dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] *= dv[e];
        }
      }
      xs[t * KC4 + swz(c)] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    const int nvec = clen / EPV;
    for (int vi = lane; vi < nvec; vi += 32) {
      // the R rows' words at this position: R independent loads in flight,
      // and every staged x value read below serves all R rows
      uint4 u[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        u[r] = live[r] ? __ldg(reinterpret_cast<const uint4*>(
                             packed + (size_t)(row0 + r) * wpr + c0 / PER) + vi)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int kloc = vi * EPV + w * PER;
        const int grp = (c0 + kloc) / g;
        float s[R], z[R];
        uint32_t wd[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const size_t gi = (size_t)(live[r] ? row0 + r : 0) * gpr + grp;
          s[r] = __ldg(S + gi);
          z[r] = __ldg(Z + gi);
          wd[r] = w == 0 ? u[r].x : w == 1 ? u[r].y : w == 2 ? u[r].z : u[r].w;
        }
#pragma unroll
        for (int h = 0; h < PER / 4; ++h) {
          float wv[R][4];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t code = (wd[r] >> ((h * 4 + e) * BITS)) & MASK;
              wv[r][e] = fmaf((float)code, s[r], z[r]);
            }
          const int c = kloc / 4 + h;
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            const float4 xv = xs[t * KC4 + swz(c)];
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
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float v = ttq::warp_sum(acc[r][t]);
      if (lane == 0 && live[r] && t0 + t < T)
        ttq::store1(y + (size_t)(t0 + t) * dp + row0 + r, v);
    }
  }
}

template <int TT, int BITS>
void launch(const void* x, int x_bf16, const int32_t* packed, const float* S,
            const float* Z, const float* dinv, void* y, int T, int dp, int d,
            int g, cudaStream_t stream) {
  const int rows_per_block = kWarps * kRowsPerWarp;
  dim3 block(kWarps * 32);
  dim3 grid((dp + rows_per_block - 1) / rows_per_block, (T + TT - 1) / TT);
  if (x_bf16)
    gemm_kernel<TT, BITS, __nv_bfloat16><<<grid, block, 0, stream>>>(
        (const __nv_bfloat16*)x, packed, S, Z, dinv, (__nv_bfloat16*)y, T,
        dp, d, g);
  else
    gemm_kernel<TT, BITS, float><<<grid, block, 0, stream>>>(
        (const float*)x, packed, S, Z, dinv, (float*)y, T, dp, d, g);
}

template <int TT>
int by_bits(const void* x, int x_bf16, const int32_t* packed, const float* S,
            const float* Z, const float* dinv, void* y, int T, int dp, int d,
            int bits, int g, cudaStream_t stream) {
  if (bits == 2) launch<TT, 2>(x, x_bf16, packed, S, Z, dinv, y, T, dp, d, g, stream);
  else if (bits == 4) launch<TT, 4>(x, x_bf16, packed, S, Z, dinv, y, T, dp, d, g, stream);
  else if (bits == 8) launch<TT, 8>(x, x_bf16, packed, S, Z, dinv, y, T, dp, d, g, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ttq_gemm_launch(const void* x, int x_bf16, const int32_t* packed,
                               const float* S, const float* Z,
                               const float* dinv, void* y, int T, int dp,
                               int d, int bits, int g, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int per = 32 / bits;
  if (T <= 0 || dp <= 0 || d % (4 * per) || d % g || g % per)
    return (int)cudaErrorInvalidValue;
  if (T <= 1) return by_bits<1>(x, x_bf16, packed, S, Z, dinv, y, T, dp, d, bits, g, stream);
  if (T <= 2) return by_bits<2>(x, x_bf16, packed, S, Z, dinv, y, T, dp, d, bits, g, stream);
  if (T <= 4) return by_bits<4>(x, x_bf16, packed, S, Z, dinv, y, T, dp, d, bits, g, stream);
  if (T <= 8) return by_bits<8>(x, x_bf16, packed, S, Z, dinv, y, T, dp, d, bits, g, stream);
  return by_bits<16>(x, x_bf16, packed, S, Z, dinv, y, T, dp, d, bits, g, stream);
}
