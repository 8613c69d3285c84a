// ttq_decode_attention — single-query GQA decode attention over an int8 or
// int4 KV cache, dequantized in registers.
//
// Replaces: src/repro/kernels/ttq_attn.py:ttq_decode_attention (Pallas
// bodies _attn_kernel and _dequant_tile).  For each (b, kv head) and each of
// its G query heads (q pre-scaled by Dh^-1/2): scores over the cache rows
// s <= cur_pos[b], optional tanh soft-cap, f32 softmax, weighted sum of the
// dequantized values.  int8 codes are code·scale; int4 codes are packed 8 per
// int32 with a -8 bias.  Scales are f32 per (head, token, group of Dh).
//
// Bound on the card: bytes.  Each cached row is read once and feeds 4·G
// flops per element, far below the H100's ridge.  Design: one block of 8
// warps per (b, kv head).  A warp takes every 8th row up to cur_pos (rows
// past it contribute exactly 0 in the reference too and are never read);
// its lanes cover the head dim 8 elements each (int8: one 8-byte load,
// int4: one int32 word), so a warp reads a whole row as one coalesced
// transaction; the value row is loaded together with the key row, so its
// latency hides behind the score.  The q group stays in registers, the score
// is a warp-shuffle sum, and each warp keeps an online softmax (running max, denominator,
// accumulator) in registers; the eight partial results are merged through
// shared memory at the end.  Split-S across blocks comes later.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e30f;

template <int BITS>
__device__ __forceinline__ void dequant8(const void* codes, const float* scales,
                                         long long row, int Dh, int ngr, int d0,
                                         float* out) {
  const int gs = Dh / ngr;
  const float sc = __ldg(scales + row * ngr + d0 / gs);
  if (BITS == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        (const int8_t*)codes + row * Dh + d0);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = (float)c[e] * sc;
  } else {
    const int32_t w = __ldg((const int32_t*)codes + row * (Dh / 8) + d0 / 8);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = (float)(((w >> (4 * e)) & 0xF) - 8) * sc;
  }
}

template <int G, int NCH, int BITS>
__global__ void __launch_bounds__(kWarps * 32) attn_kernel(
    const float* __restrict__ qg, const void* __restrict__ kq,
    const float* __restrict__ ks, const void* __restrict__ vq,
    const float* __restrict__ vs, const int32_t* __restrict__ cur_pos,
    float* __restrict__ out, int Hkv, int S, int Dh, int ngr, float soft_cap) {
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][NCH * 256];

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float q[G][NCH][8], acc[G][NCH][8], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int d0 = (ch * 32 + lane) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        q[gi][ch][e] = d0 < Dh ? qg[((long long)bh * G + gi) * Dh + d0 + e] : 0.0f;
        acc[gi][ch][e] = 0.0f;
      }
    }
  }

  const int last = min(cur_pos[b], S - 1);
  for (int s = warp; s <= last; s += kWarps) {
    const long long row = (long long)bh * S + s;
    float score[G];
    float vrow[NCH][8];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) score[gi] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int d0 = (ch * 32 + lane) * 8;
      if (d0 < Dh) {
        float k[8];
        dequant8<BITS>(kq, ks, row, Dh, ngr, d0, k);
        dequant8<BITS>(vq, vs, row, Dh, ngr, d0, vrow[ch]);
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int e = 0; e < 8; ++e) score[gi] = fmaf(q[gi][ch][e], k[e], score[gi]);
      }
    }
    float p[G], alpha[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float sc = ttq::warp_sum(score[gi]);
      if (soft_cap > 0.0f) sc = soft_cap * tanhf(sc / soft_cap);
      const float m_new = fmaxf(m[gi], sc);
      alpha[gi] = expf(m[gi] - m_new);
      p[gi] = expf(sc - m_new);
      l[gi] = l[gi] * alpha[gi] + p[gi];
      m[gi] = m_new;
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int d0 = (ch * 32 + lane) * 8;
      if (d0 < Dh) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[gi][ch][e] = fmaf(p[gi], vrow[ch][e], acc[gi][ch][e] * alpha[gi]);
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) { sm_m[warp][gi] = m[gi]; sm_l[warp][gi] = l[gi]; }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int d0 = (ch * 32 + lane) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (d0 < Dh) sm_acc[warp][gi][d0 + e] = acc[gi][ch][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
    const int gi = i / Dh, dd = i - gi * Dh;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][gi]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][gi] - M);
      L = fmaf(sm_l[w][gi], f, L);
      A = fmaf(sm_acc[w][gi][dd], f, A);
    }
    out[((long long)bh * G + gi) * Dh + dd] = A / fmaxf(L, 1e-30f);
  }
}

template <int G, int NCH>
int launch(const float* qg, const void* kq, const float* ks, const void* vq,
           const float* vs, const int32_t* cur_pos, float* out, int B, int Hkv,
           int S, int Dh, int ngr, int bits, float soft_cap,
           cudaStream_t stream) {
  dim3 grid(B * Hkv), block(kWarps * 32);
  if (bits == 8)
    attn_kernel<G, NCH, 8><<<grid, block, 0, stream>>>(
        qg, kq, ks, vq, vs, cur_pos, out, Hkv, S, Dh, ngr, soft_cap);
  else if (bits == 4)
    attn_kernel<G, NCH, 4><<<grid, block, 0, stream>>>(
        qg, kq, ks, vq, vs, cur_pos, out, Hkv, S, Dh, ngr, soft_cap);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ttq_decode_attention_launch(
    const float* qg, const void* kq, const float* ks, const void* vq,
    const float* vs, const int32_t* cur_pos, float* out, int B, int Hkv, int G,
    int S, int Dh, int ngr, int bits, float soft_cap, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B <= 0 || Hkv <= 0 || S <= 0 || Dh % 8 || Dh > 512 || ngr <= 0 ||
      Dh % ngr || (Dh / ngr) % 8)
    return (int)cudaErrorInvalidValue;
  const int nch = (Dh + 255) / 256;
#define TTQ_A(GG, NN) \
  if (G == GG && nch == NN) return launch<GG, NN>(qg, kq, ks, vq, vs, cur_pos, out, B, Hkv, S, Dh, ngr, bits, soft_cap, stream);
  TTQ_A(1, 1) TTQ_A(2, 1) TTQ_A(4, 1)
  TTQ_A(1, 2) TTQ_A(2, 2)
#undef TTQ_A
  return (int)cudaErrorInvalidValue;
}
