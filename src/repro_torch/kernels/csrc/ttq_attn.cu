// ttq_decode_attention and ttq_paged_decode_attention — single-query GQA
// decode attention over an int8 or int4 KV cache, dequantized in registers;
// the cache is a dense slab or a paged pool.  The rows of each (slot, kv
// head) are split across a thread-block cluster and the partial softmax
// states are merged in distributed shared memory, in one launch.
//
// Replaces: src/repro/kernels/ttq_attn.py:ttq_decode_attention (Pallas
// bodies _attn_kernel and _dequant_tile) and
// src/repro/kernels/ttq_attn.py:ttq_paged_decode_attention (Pallas body
// _paged_attn_kernel).  For each (b, kv head) and each of its G query heads:
// q (bf16 or f32) times `scale` in f32, scores over the cache rows
// s <= cur_pos[b], optional tanh soft-cap, f32 softmax, weighted sum of the
// dequantized values, written in q's dtype (round to nearest even).  int8
// codes are code·scale; int4 codes are packed 8 per int32 with a -8 bias.
// Scales are f32 per (head, token, group of Dh).  The dense cache is
// (B, Hkv, S, ·); the paged cache is a (NB, Hkv, bs, ·) pool whose logical
// block j of slot b is physical block block_table[b, j].
//
// Bound on the card: bytes at small G.  Each live cached row is read once
// and feeds 4·G flops per element (f32, CUDA cores): at G <= 4 far below
// the H100's ridge, where the instructions per row bind first (below); at
// G = 12 or 48 past it (about 20 flops per byte), so those are bound by
// the flops.
//
// Heads: the G query heads of a kv head are cut into ceil(G / Gt) tiles of
// Gt in {1, 2, 4} heads (Gt·NCH <= 4, for registers; the wrapper's
// head_tile picks Gt), one tile per cluster: the tile is another grid axis
// next to (b, kv head).  Heads past G in the last tile run on q = 0 and are
// never stored (G = 3: one tile of 4, one head masked).  Each tile walks
// the rows of its (b, kv head) itself, so a row is read ceil(G / Gt) times,
// the later reads mostly from L2 (the tiles of one kv head are neighbours
// in the grid).  G in {1, 2, 4} is one tile: the walk of a single tile is
// the one it was before tiles.
//
// Split: the C blocks of one cluster (C in {1, 2, 4, 8}, from the wrapper's
// attn_splits) share one (b, kv head, head tile); rank r takes the
// contiguous slice r of rows 0..min(cur_pos[b], capacity - 1) cut into C
// slices of ceil(n / C) rows, computed on the device (the host never reads
// cur_pos).  So B·Hkv·T·C blocks fill the card where B·Hkv alone (64 for
// gemma-7b at 4 slots) leaves half the SMs idle, and a long slot is walked
// by C SMs.
// Rows past cur_pos contribute exactly 0 in the reference too and are never
// read (the paged kernel never reads the sink block 0); a rank with no rows
// keeps m = -1e30, l = 0, acc = 0 and adds exactly nothing in the merge.
//
// Walk: 8 warps per block; warp w takes rows lo + w, lo + w + 8, ... of its
// rank's slice, P at a time: the codes and scales of P rows are loaded
// before the first row's score, so a warp keeps P rows of key and value
// loads in flight (P = 8, 4 or 2 as G·Dh/256 grows, for registers).  Lanes
// cover the head dim 8 elements each (int8: one 8-byte load, int4: one
// int32 word), so a warp reads a row as one coalesced transaction.  Past
// the bytes, the bound is the instruction rate: every instruction of a row
// is paid once per 8 elements of a lane, so the walk keeps them few.  Codes
// become f32 by a byte permute (int8) or shift and mask (int4) into a magic
// float and one subtraction (no int-to-float conversion, a quarter-rate
// unit), and int4 keys without the subtraction (see key_f32); the scales
// multiply a lane's partial dot product and a row's probability, not each
// element, and with one scale group per row (RS, the default group size) a
// lane loads only its own row's two scales per batch; a row is 32-bit
// addressed from per-lane base pointers.  The P·G scores of a batch are
// summed across the warp in one transposed reduction (each exchange halves
// the values a lane holds: 9 shuffles for 8 scores, where a warp sum per
// score takes 40), which leaves each lane with one score: soft cap and exp
// run once per lane, and each warp keeps an online softmax (running max,
// denominator, accumulator) updated once per batch.
//
// Merge, in one launch and deterministic: each rank merges its 8 warps'
// states in warp order into its shared memory; a cluster barrier; rank r
// takes Dh/C columns of the output and reads the state of ranks 0..C-1
// through distributed shared memory in rank order, merges, casts and
// stores; a second cluster barrier keeps every rank's shared memory alive
// until the last read.  No atomics and no workspace: two calls are bitwise
// equal.  The dense and paged kernels share this walk (attn_split) and
// differ only in the address functor that maps a logical row to a physical
// one: the paged block first copies the part of its slot's block-table row
// that covers its slice into shared memory (in place of Pallas' scalar
// prefetch).  Both cut the same slices and visit the same rows in the same
// order with the same arithmetic, so the paged kernel equals the dense
// kernel bit for bit on the gathered cache.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 8;
constexpr float kNegInf = -1e30f;

// the 8 codes a lane holds of one row: int8 one 8-byte word, int4 one int32;
// a row is Dh / 8 of them
template <int BITS> struct Codes { using Word = uint2; Word u; };
template <> struct Codes<4> { using Word = uint32_t; Word u; };

// The 8 codes as exact f32 integers, without a conversion instruction: a
// code c sits in the low bits of the f32 2^23 + c + bias (a byte permute or
// shift-and-mask puts it there), and subtracting 2^23 + bias is exact.
// int8: bias 128 (c ^ 0x80 = c + 128 as a byte); int4: bias 8 (the code is
// the nibble - 8).  The int-to-float unit runs at a quarter of the FMA rate
// and would bound the kernel.
template <int BITS>
__device__ __forceinline__ void codes_f32(const Codes<BITS>& c, float* out) {
  if constexpr (BITS == 8) {
    const uint32_t w[2] = {c.u.x ^ 0x80808080u, c.u.y ^ 0x80808080u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = __uint_as_float(__byte_perm(w[e / 4], 0x4B000000u,
                                           0x7440u + (e & 3))) - 8388736.0f;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = __uint_as_float(0x4B000000u | ((c.u >> (4 * e)) & 0xFu)) -
               8388616.0f;
  }
}

// Keys as the score product takes them: int8 as codes_f32; int4 as the
// exact f32 1 + n/16 = 1.5 + c/16 of each nibble n (shift and mask into
// the mantissa of 1.0, no subtraction), which the product takes against
// 16·q, so that a lane's 8 products less 1.5·Σ 16·q are its partial score.
template <int BITS>
__device__ __forceinline__ void key_f32(const Codes<BITS>& c, float* out) {
  if constexpr (BITS == 8) {
    codes_f32<8>(c, out);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t m = 4 * e <= 19 ? c.u << (19 - 4 * e) : c.u >> (4 * e - 19);
      out[e] = __uint_as_float(0x3F800000u | (m & 0x00780000u));
    }
  }
}

// logical row s of (b, h) → physical row of the (B, Hkv, S, ·) slab
struct DenseRows {
  uint32_t base;                        // (b·Hkv + h)·S
  __device__ __forceinline__ uint32_t operator()(int s) const { return base + s; }
};

// logical row s of (b, h) → physical row of the (NB, Hkv, bs, ·) pool.
// s / bs by a multiply-high with ceil(2^32 / bs): exact for s·bs < 2^32,
// which nblk <= 2048 and bs <= 1024 guarantee.  At bs = 1 the multiplier
// (2^32) does not fit 32 bits: the block is s itself.
struct PagedRows {
  const int32_t* bt;                    // logical blocks b0.. of slot b (shared)
  int b0, Hkv, h, bs;
  uint32_t inv_bs;                      // 0xFFFFFFFF / bs + 1 (0 at bs = 1)
  __device__ __forceinline__ uint32_t operator()(int s) const {
    const int blk = bs == 1 ? s : (int)__umulhi((uint32_t)s, inv_bs);
    return ((uint32_t)bt[blk - b0] * Hkv + h) * bs + (s - blk * bs);
  }
};

// Warp sums of the N values x (N a power of two <= 32): log2(N) exchange
// steps, each halving the values a lane holds, then butterfly steps.  Lane l
// returns the sum over the warp of x[l / (32 / N)], bitwise the same in each
// of the 32 / N lanes that hold it.  N - 1 + 5 - log2(N) shuffles, where one
// warp_sum per value takes 5·N.
template <int N>
__device__ __forceinline__ float warp_sums(float* x, int lane) {
  constexpr int LOG = N == 1 ? 0 : N == 2 ? 1 : N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  static_assert((1 << LOG) == N, "N is a power of two <= 32");
#pragma unroll
  for (int step = 0; step < LOG; ++step) {
    const int off = 16 >> step, half = N >> (step + 1);
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? x[i] : x[i + half];
      const float keep = upper ? x[i + half] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float v = x[0];
#pragma unroll
  for (int off = 16 >> LOG; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rank `rank` of C: rows [lo, hi) of rows 0..last
__device__ __forceinline__ void slice_rows(int last, int C, int rank, int& lo,
                                           int& hi) {
  const int n = last + 1;
  const int chunk = (n + C - 1) / C;
  lo = min(n, rank * chunk);
  hi = min(n, lo + chunk);
}

// The shared walk: rows [lo, hi) of one (b, kv head) in this rank for a
// tile of G query heads starting at query head qh0, of which the first gv
// are real (the rest run on q = 0 and are not stored), merged across the
// cluster into out[qh0 .. qh0 + gv) (Dh values each, in q's dtype).
template <int G, int NCH, int BITS, bool RS, class Rows>
__device__ __forceinline__ void attn_split(
    const void* __restrict__ q, int q_bf16, float scale,
    const void* __restrict__ kq, const float* __restrict__ ks,
    const void* __restrict__ vq, const float* __restrict__ vs,
    void* __restrict__ out, int qh0, int gv, int lo, int hi, int Dh, int ngr,
    float soft_cap, const Rows rows) {
  constexpr int P = G * NCH == 1 ? 8 : G * NCH == 2 ? 4 : 2;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][NCH * 256];  // [0]: the rank's merged acc
  __shared__ float rk_m[G], rk_l[G];              // the rank's merged m, l

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gs = Dh / ngr;

  float qr[G][NCH][8], acc[G][NCH][8], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int d0 = (ch * 32 + lane) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[gi][ch][e] = acc[gi][ch][e] = 0.0f;
      if (d0 < Dh && gi < gv) {
        const long long off = ((long long)qh0 + gi) * Dh + d0;
        if (q_bf16) {
          ttq::load4(static_cast<const __nv_bfloat16*>(q) + off, qr[gi][ch]);
          ttq::load4(static_cast<const __nv_bfloat16*>(q) + off + 4, qr[gi][ch] + 4);
        } else {
          ttq::load4(static_cast<const float*>(q) + off, qr[gi][ch]);
          ttq::load4(static_cast<const float*>(q) + off + 4, qr[gi][ch] + 4);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[gi][ch][e] *= scale;
      }
    }
  }

  // int4 keys: the product runs on 1 + n/16 (see key_f32) against 16·q, and
  // 1.5·Σ 16·q comes off a lane's partial dot once per row
  float qoff[G][NCH];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float t = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (BITS == 4) qr[gi][ch][e] *= 16.0f;
        t += qr[gi][ch][e];
      }
      qoff[gi][ch] = 1.5f * t;
    }

  // a lane's codes and scales in row 0: row r is Dh / 8 words and ngr
  // scales further on
  using Word = typename Codes<BITS>::Word;
  const Word* kp[NCH];
  const Word* vp[NCH];
  const float* ksp[NCH];
  const float* vsp[NCH];
  bool on[NCH];                         // the lane covers part of the head dim
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const int u = ch * 32 + lane;       // 8 codes per word
    on[ch] = NCH * 256 == Dh || u * 8 < Dh;
    kp[ch] = static_cast<const Word*>(kq) + u;
    vp[ch] = static_cast<const Word*>(vq) + u;
    ksp[ch] = ks + u * 8 / gs;
    vsp[ch] = vs + u * 8 / gs;
  }
  const uint32_t rw = Dh / 8;
  // after the transposed reduction lane l holds score j = l / LPV: row
  // j / G of the batch, head j % G
  constexpr int LPV = 32 / (P * G);
  const int j = lane / LPV, pj = j / G, gj = j - pj * G;

  for (int s0 = lo + warp; s0 < hi; s0 += kWarps * P) {
    // P rows' codes and scales, all in flight before the first score; rows
    // past hi (the last batch's tail) load row hi - 1 again and are masked
    // out of the softmax: no branch per row.  With one scale group per row
    // (RS) a lane loads only the scales of its own row j.
    Codes<BITS> kc[P][NCH], vc[P][NCH];
    float ksc[P][NCH], vsc[P][NCH], ksj = 1.0f, vsj = 1.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t row = rows(min(s0 + p * kWarps, hi - 1));
      const size_t cw = (size_t)row * rw, sw = (size_t)row * ngr;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        kc[p][ch].u = on[ch] ? __ldg(kp[ch] + cw) : Word{};
        vc[p][ch].u = on[ch] ? __ldg(vp[ch] + cw) : Word{};
        if constexpr (!RS) {
          ksc[p][ch] = on[ch] ? __ldg(ksp[ch] + sw) : 0.0f;
          vsc[p][ch] = on[ch] ? __ldg(vsp[ch] + sw) : 0.0f;
        }
      }
    }
    if constexpr (RS) {
      const uint32_t rj = rows(min(s0 + pj * kWarps, hi - 1));
      ksj = __ldg(ks + rj);
      vsj = __ldg(vs + rj);
    }
    // scores: a lane's 8 products with the codes (times its group's scale
    // unless RS, where the reduced score is scaled once)
    float sc[P][G];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) sc[p][gi] = 0.0f;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float k[8];
        key_f32<BITS>(kc[p][ch], k);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float dot = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qr[gi][ch][e], k[e], dot);
          if (BITS == 4) dot -= qoff[gi][ch];
          sc[p][gi] = RS ? sc[p][gi] + dot : fmaf(dot, ksc[p][ch], sc[p][gi]);
        }
      }
    }
    // the P·G scores' warp sums, one per lane group; soft cap and exp once
    // per lane
    float sj = warp_sums<P * G>(&sc[0][0], lane) * ksj;
    if (soft_cap > 0.0f) sj = soft_cap * tanhf(sj / soft_cap);
    const bool okj = s0 + pj * kWarps < hi;
    // online softmax, once per P rows: each head's batch max and row sum
    // over the lanes of its P rows
    float mx = okj ? sj : kNegInf;
#pragma unroll
    for (int off = LPV * G; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float m_old = m[0];
#pragma unroll
    for (int gi = 1; gi < G; ++gi) m_old = gj == gi ? m[gi] : m_old;
    const float m_new = fmaxf(m_old, mx);
    const float ej = expf(sj - m_new);    // a masked lane's may overflow
    const float pr = okj ? ej : 0.0f;
    float ps = pr;
#pragma unroll
    for (int off = LPV * G; off < 32; off <<= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    float alpha[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {     // head gi's from its row-0 lanes
      const float mg = G == 1 ? m_new : __shfl_sync(0xffffffffu, m_new, gi * LPV);
      const float lg = G == 1 ? ps : __shfl_sync(0xffffffffu, ps, gi * LPV);
      alpha[gi] = expf(m[gi] - mg);
      l[gi] = fmaf(l[gi], alpha[gi], lg);
      m[gi] = mg;
    }
    // every row's p (RS: times its value scale) in every lane
    const float pvj = pr * vsj;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        sc[p][gi] = __shfl_sync(0xffffffffu, pvj, (p * G + gi) * LPV);
    // values: acc += (p_row · scale) · code
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[gi][ch][e] *= alpha[gi];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float v[8];
        codes_f32<BITS>(vc[p][ch], v);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float pv = RS ? sc[p][gi] : sc[p][gi] * vsc[p][ch];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[gi][ch][e] = fmaf(pv, v[e], acc[gi][ch][e]);
        }
      }
    }
  }

  // this rank: the warps' states merged in warp order
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
  for (int i = threadIdx.x; i < gv * Dh; i += kThreads) {
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
    sm_acc[0][gi][dd] = A;              // read and written by this thread only
    if (dd == 0) { rk_m[gi] = M; rk_l[gi] = L; }
  }
  cluster.sync();                       // every rank's state is written

  // the cluster: rank r's Dh/C columns, ranks merged in rank order
  const int cols = Dh / C;
  for (int i = threadIdx.x; i < gv * cols; i += kThreads) {
    const int gi = i / cols, dd = rank * cols + (i - gi * cols);
    float mr[kMaxSplit];
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      mr[r] = r < C ? cluster.map_shared_rank(&rk_m[0], r)[gi] : kNegInf;
      M = fmaxf(M, mr[r]);
    }
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < C) {
        const float f = expf(mr[r] - M);
        L = fmaf(cluster.map_shared_rank(&rk_l[0], r)[gi], f, L);
        A = fmaf(cluster.map_shared_rank(&sm_acc[0][gi][0], r)[dd], f, A);
      }
    }
    const float o = A / fmaxf(L, 1e-30f);
    const long long off = ((long long)qh0 + gi) * Dh + dd;
    if (q_bf16) ttq::store1(static_cast<__nv_bfloat16*>(out) + off, o);
    else ttq::store1(static_cast<float*>(out) + off, o);
  }
  cluster.sync();                       // no rank's state is read any more
}

// cluster blockIdx.x / C → (b·Hkv + h, tile t): the first query head of
// tile t of the GQ heads of kv head bh, and how many of its G are real
struct Tile {
  int bh, qh0, gv;
  template <int G>
  __device__ __forceinline__ static Tile of(int cluster_id, int GQ, int T) {
    const int bh = cluster_id / T, t = cluster_id - bh * T;
    return Tile{bh, bh * GQ + t * G, min(G, GQ - t * G)};
  }
};

template <int G, int NCH, int BITS, bool RS>
__global__ void __launch_bounds__(kThreads) attn_kernel(
    const void* __restrict__ q, int q_bf16, float scale,
    const void* __restrict__ kq, const float* __restrict__ ks,
    const void* __restrict__ vq, const float* __restrict__ vs,
    const int32_t* __restrict__ cur_pos, void* __restrict__ out, int Hkv,
    int GQ, int T, int S, int Dh, int ngr, float soft_cap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const Tile tl = Tile::of<G>(blockIdx.x / C, GQ, T);
  int lo, hi;
  slice_rows(min(cur_pos[tl.bh / Hkv], S - 1), C, (int)cluster.block_rank(),
             lo, hi);
  attn_split<G, NCH, BITS, RS>(q, q_bf16, scale, kq, ks, vq, vs, out, tl.qh0,
                               tl.gv, lo, hi, Dh, ngr, soft_cap,
                               DenseRows{(uint32_t)tl.bh * S});
}

template <int G, int NCH, int BITS, bool RS>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(
    const void* __restrict__ q, int q_bf16, float scale,
    const void* __restrict__ kq, const float* __restrict__ ks,
    const void* __restrict__ vq, const float* __restrict__ vs,
    const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ cur_pos, void* __restrict__ out, int Hkv,
    int GQ, int T, int bs, int nblk, int Dh, int ngr, float soft_cap) {
  extern __shared__ int32_t sm_bt[];    // the slice's blocks, at most nblk
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const Tile tl = Tile::of<G>(blockIdx.x / C, GQ, T);
  const int b = tl.bh / Hkv, h = tl.bh - b * Hkv;
  int lo, hi;
  slice_rows(min(cur_pos[b], nblk * bs - 1), C, (int)cluster.block_rank(), lo,
             hi);
  const int b0 = lo / bs, nb = hi > lo ? (hi - 1) / bs - b0 + 1 : 0;
  for (int i = threadIdx.x; i < nb; i += kThreads)
    sm_bt[i] = block_table[(long long)b * nblk + b0 + i];
  __syncthreads();
  attn_split<G, NCH, BITS, RS>(
      q, q_bf16, scale, kq, ks, vq, vs, out, tl.qh0, tl.gv, lo, hi, Dh, ngr,
      soft_cap, PagedRows{sm_bt, b0, Hkv, h, bs, 0xFFFFFFFFu / (uint32_t)bs + 1u});
}

// Launch geometry shared by both entry points: grid B·Hkv·T·C in clusters
// of C, 8 warps per block; T = ceil(GQ / Gt) head tiles per kv head.
struct Args {
  const void* q; int q_bf16; float scale;
  const void* kq; const float* ks; const void* vq; const float* vs;
  const int32_t* block_table; const int32_t* cur_pos; void* out;
  int B, Hkv, GQ, S, bs, nblk, Dh, ngr; float soft_cap; int splits, tiles;
  cudaStream_t stream;
};

template <int G, int NCH, int BITS, bool RS>
int launch_kernel(const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hkv * a.tiles * a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (a.block_table == nullptr) {
    e = cudaLaunchKernelEx(&cfg, attn_kernel<G, NCH, BITS, RS>, a.q, a.q_bf16,
                           a.scale, a.kq, a.ks, a.vq, a.vs, a.cur_pos, a.out,
                           a.Hkv, a.GQ, a.tiles, a.S, a.Dh, a.ngr, a.soft_cap);
  } else {
    cfg.dynamicSmemBytes = a.nblk * sizeof(int32_t);
    e = cudaLaunchKernelEx(&cfg, paged_attn_kernel<G, NCH, BITS, RS>, a.q,
                           a.q_bf16, a.scale, a.kq, a.ks, a.vq, a.vs,
                           a.block_table, a.cur_pos, a.out, a.Hkv, a.GQ,
                           a.tiles, a.bs, a.nblk, a.Dh, a.ngr, a.soft_cap);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// RS: one scale group per row (the default group size, Dh)
template <int G, int NCH, int BITS>
int launch_bits(const Args& a) {
  return a.ngr == 1 ? launch_kernel<G, NCH, BITS, true>(a)
                    : launch_kernel<G, NCH, BITS, false>(a);
}

// Gt: the heads of one tile (the template's G), in {1, 2, 4} with
// Gt·NCH <= 4
int launch(Args a, int gt, int bits) {
  if (a.B <= 0 || a.Hkv <= 0 || a.GQ <= 0 || a.Dh % 8 || a.Dh > 512 ||
      a.ngr <= 0 || a.Dh % a.ngr || (a.Dh / a.ngr) % 8 ||
      (bits != 4 && bits != 8) ||
      (a.splits != 1 && a.splits != 2 && a.splits != 4 &&
       a.splits != kMaxSplit))
    return (int)cudaErrorInvalidValue;
  a.tiles = (a.GQ + gt - 1) / gt;
  if ((long long)a.B * a.Hkv * a.tiles * a.splits >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int nch = (a.Dh + 255) / 256;
#define TTQ_A(GG, NN)                                               \
  if (gt == GG && nch == NN)                                        \
    return bits == 8 ? launch_bits<GG, NN, 8>(a) : launch_bits<GG, NN, 4>(a);
  TTQ_A(1, 1) TTQ_A(2, 1) TTQ_A(4, 1)
  TTQ_A(1, 2) TTQ_A(2, 2)
#undef TTQ_A
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ttq_decode_attention_launch(
    const void* q, int q_bf16, float scale, const void* kq, const float* ks,
    const void* vq, const float* vs, const int32_t* cur_pos, void* out, int B,
    int Hkv, int G, int gt, int S, int Dh, int ngr, int bits, float soft_cap,
    int splits, void* stream_ptr) {
  if (S <= 0 || (long long)B * Hkv * S >= (1LL << 31))  // 32-bit rows
    return (int)cudaErrorInvalidValue;
  return launch(Args{q, q_bf16, scale, kq, ks, vq, vs, nullptr, cur_pos, out,
                     B, Hkv, G, S, 0, 0, Dh, ngr, soft_cap, splits, 0,
                     (cudaStream_t)stream_ptr},
                gt, bits);
}

extern "C" int ttq_paged_decode_attention_launch(
    const void* q, int q_bf16, float scale, const void* kq, const float* ks,
    const void* vq, const float* vs, const int32_t* block_table,
    const int32_t* cur_pos, void* out, int B, int Hkv, int G, int gt, int bs,
    int nblk, int Dh, int ngr, int bits, float soft_cap, int splits,
    void* stream_ptr) {
  if (block_table == nullptr || bs <= 0 || bs > 1024 || nblk <= 0 ||
      nblk > 2048)
    return (int)cudaErrorInvalidValue;
  return launch(Args{q, q_bf16, scale, kq, ks, vq, vs, block_table, cur_pos,
                     out, B, Hkv, G, 0, bs, nblk, Dh, ngr, soft_cap, splits, 0,
                     (cudaStream_t)stream_ptr},
                gt, bits);
}
