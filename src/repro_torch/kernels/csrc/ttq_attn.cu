// ttq_decode_attention and ttq_paged_decode_attention — single-query GQA
// decode attention over an int8 or int4 KV cache, dequantized in registers;
// the cache is a dense slab or a paged pool.
//
// Replaces: src/repro/kernels/ttq_attn.py:ttq_decode_attention (Pallas
// bodies _attn_kernel and _dequant_tile) and
// src/repro/kernels/ttq_attn.py:ttq_paged_decode_attention (Pallas body
// _paged_attn_kernel).  For each (b, kv head) and each of its G query heads
// (q pre-scaled by Dh^-1/2): scores over the cache rows s <= cur_pos[b],
// optional tanh soft-cap, f32 softmax, weighted sum of the dequantized
// values.  int8 codes are code·scale; int4 codes are packed 8 per int32 with
// a -8 bias.  Scales are f32 per (head, token, group of Dh).  The dense
// cache is (B, Hkv, S, ·); the paged cache is a (NB, Hkv, bs, ·) pool whose
// logical block j of slot b is physical block block_table[b, j].
//
// Bound on the card: bytes.  Each live cached row is read once and feeds
// 4·G flops per element, far below the H100's ridge.  Design: one block of
// 8 warps per (b, kv head).  A warp takes every 8th row up to cur_pos (rows
// past it contribute exactly 0 in the reference too and are never read, so
// the paged kernel never reads the sink block 0); its lanes cover the head
// dim 8 elements each (int8: one 8-byte load, int4: one int32 word), so a
// warp reads a whole row as one coalesced transaction; the value row is
// loaded together with the key row, so its latency hides behind the score.
// The q group stays in registers, the score is a warp-shuffle sum, and each
// warp keeps an online softmax (running max, denominator, accumulator) in
// registers; the eight partial results are merged through shared memory at
// the end.  The two kernels share this walk (attn_rows) and differ only in
// the address functor that maps a logical row to a physical one: the paged
// block first copies its slot's block-table row into shared memory (in
// place of Pallas' scalar prefetch) and then adds one level of indexing.
// Both visit the same rows in the same order with the same arithmetic, so
// the paged kernel equals the dense kernel bit for bit on the gathered
// cache.  Split-S across blocks comes later.
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

// logical row s of (b, h) → physical row of the (B, Hkv, S, ·) slab
struct DenseRows {
  long long base;                       // (b·Hkv + h)·S
  __device__ __forceinline__ long long operator()(int s) const { return base + s; }
};

// logical row s of (b, h) → physical row of the (NB, Hkv, bs, ·) pool
struct PagedRows {
  const int32_t* bt;                    // slot b's block-table row (shared)
  int Hkv, h, bs;
  __device__ __forceinline__ long long operator()(int s) const {
    return ((long long)bt[s / bs] * Hkv + h) * bs + s % bs;
  }
};

// The shared row walk: rows 0..last of (b, h) = block ``bh``, online
// softmax per warp, merge through shared memory, write out[bh].
template <int G, int NCH, int BITS, class Rows>
__device__ __forceinline__ void attn_rows(
    const float* __restrict__ qg, const void* __restrict__ kq,
    const float* __restrict__ ks, const void* __restrict__ vq,
    const float* __restrict__ vs, float* __restrict__ out, int bh, int last,
    int Dh, int ngr, float soft_cap, const Rows rows) {
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][NCH * 256];

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

  for (int s = warp; s <= last; s += kWarps) {
    const long long row = rows(s);
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

template <int G, int NCH, int BITS>
__global__ void __launch_bounds__(kWarps * 32) attn_kernel(
    const float* __restrict__ qg, const void* __restrict__ kq,
    const float* __restrict__ ks, const void* __restrict__ vq,
    const float* __restrict__ vs, const int32_t* __restrict__ cur_pos,
    float* __restrict__ out, int Hkv, int S, int Dh, int ngr, float soft_cap) {
  const int bh = blockIdx.x;
  attn_rows<G, NCH, BITS>(qg, kq, ks, vq, vs, out, bh,
                          min(cur_pos[bh / Hkv], S - 1), Dh, ngr, soft_cap,
                          DenseRows{(long long)bh * S});
}

template <int G, int NCH, int BITS>
__global__ void __launch_bounds__(kWarps * 32) paged_attn_kernel(
    const float* __restrict__ qg, const void* __restrict__ kq,
    const float* __restrict__ ks, const void* __restrict__ vq,
    const float* __restrict__ vs, const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ cur_pos, float* __restrict__ out, int Hkv,
    int bs, int nblk, int Dh, int ngr, float soft_cap) {
  extern __shared__ int32_t sm_bt[];    // nblk entries
  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh - b * Hkv;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x)
    sm_bt[i] = block_table[(long long)b * nblk + i];
  __syncthreads();
  attn_rows<G, NCH, BITS>(qg, kq, ks, vq, vs, out, bh,
                          min(cur_pos[b], nblk * bs - 1), Dh, ngr, soft_cap,
                          PagedRows{sm_bt, Hkv, h, bs});
}

// Launch geometry shared by both entry points: grid B·Hkv, 8 warps.
struct Args {
  const float* qg; const void* kq; const float* ks; const void* vq;
  const float* vs; const int32_t* block_table; const int32_t* cur_pos;
  float* out; int B, Hkv, S, bs, nblk, Dh, ngr; float soft_cap;
  cudaStream_t stream;
};

template <int G, int NCH, int BITS>
int launch_bits(const Args& a) {
  dim3 grid(a.B * a.Hkv), block(kWarps * 32);
  if (a.block_table == nullptr) {
    attn_kernel<G, NCH, BITS><<<grid, block, 0, a.stream>>>(
        a.qg, a.kq, a.ks, a.vq, a.vs, a.cur_pos, a.out, a.Hkv, a.S, a.Dh,
        a.ngr, a.soft_cap);
  } else {
    paged_attn_kernel<G, NCH, BITS><<<grid, block, a.nblk * sizeof(int32_t),
                                      a.stream>>>(
        a.qg, a.kq, a.ks, a.vq, a.vs, a.block_table, a.cur_pos, a.out, a.Hkv,
        a.bs, a.nblk, a.Dh, a.ngr, a.soft_cap);
  }
  return (int)cudaGetLastError();
}

int launch(const Args& a, int G, int bits) {
  if (a.B <= 0 || a.Hkv <= 0 || a.Dh % 8 || a.Dh > 512 || a.ngr <= 0 ||
      a.Dh % a.ngr || (a.Dh / a.ngr) % 8 || (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const int nch = (a.Dh + 255) / 256;
#define TTQ_A(GG, NN)                                               \
  if (G == GG && nch == NN)                                         \
    return bits == 8 ? launch_bits<GG, NN, 8>(a) : launch_bits<GG, NN, 4>(a);
  TTQ_A(1, 1) TTQ_A(2, 1) TTQ_A(4, 1)
  TTQ_A(1, 2) TTQ_A(2, 2)
#undef TTQ_A
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ttq_decode_attention_launch(
    const float* qg, const void* kq, const float* ks, const void* vq,
    const float* vs, const int32_t* cur_pos, float* out, int B, int Hkv, int G,
    int S, int Dh, int ngr, int bits, float soft_cap, void* stream_ptr) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  return launch(Args{qg, kq, ks, vq, vs, nullptr, cur_pos, out, B, Hkv, S, 0,
                     0, Dh, ngr, soft_cap, (cudaStream_t)stream_ptr},
                G, bits);
}

extern "C" int ttq_paged_decode_attention_launch(
    const float* qg, const void* kq, const float* ks, const void* vq,
    const float* vs, const int32_t* block_table, const int32_t* cur_pos,
    float* out, int B, int Hkv, int G, int bs, int nblk, int Dh, int ngr,
    int bits, float soft_cap, void* stream_ptr) {
  if (block_table == nullptr || bs <= 0 || nblk <= 0 || nblk > 2048)
    return (int)cudaErrorInvalidValue;
  return launch(Args{qg, kq, ks, vq, vs, block_table, cur_pos, out, B, Hkv, 0,
                     bs, nblk, Dh, ngr, soft_cap, (cudaStream_t)stream_ptr},
                G, bits);
}
