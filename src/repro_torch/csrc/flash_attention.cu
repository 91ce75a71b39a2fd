// Flash-attention forward (GQA, causal, sliding window), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_fwd (its pallas_call
// is at line 121). It computes the same function:
//
//   out[b, i, h] = sum_j softmax_j(s_ij) v[b, j, kv(h)]
//   s_ij = (q[b, i, h] . k[b, j, kv(h)]) * hd^-0.5, or -1e30 where masked
//   kv(h) = h / (nq / nkv)       (GQA; repeated kv is never materialised)
//   masked: (causal && j > q_offset + i) || (window && j <= q_offset + i - window)
//
// q is (b, tq, nq, hd), k and v are (b, tk, nkv, hd), all contiguous, hd in
// {16, 64, 128, 256} (the models use 64, 128 and, in recurrentgemma-9b's
// local layers, 256; the reduced smoke configs 16);
// the output has q's shape and dtype. The softmax is online, in f32, started at
// m = -1e30, and the output is acc / max(l, 1e-30). Masked scores are
// -1e30 and not -inf, as in the reference, so a query row whose every key is
// masked averages all tk values. Keys past tk are absent (score -inf, weight
// exactly 0): any tq and tk work, the edges are masked here.
//
// What bounds it on an H100 SXM: per (query, unmasked key) pair it does
// 2*hd FLOP for q.k and 2*hd for p.v, against reading q, k, v once and
// writing the output once. At the serving prefill (b=4, t=4096, nq=16,
// nkv=8, hd=128, causal) that is 2.75e11 FLOP against 0.2 GB: operations
// bound (0.28 ms at 989 TFLOP/s bf16, 0.06 ms of bytes at 3.35 TB/s).
//
// Design. The TPU kernel walks a (b*nq, q tile, kv tile) grid in order and
// keeps m, l and the accumulator in VMEM scratch across the kv steps. Here
// one CTA owns one (batch*q-head, q tile) and loops over the kv tiles of its
// kv head itself, holding m, l and the accumulator in registers, and writes
// its output tile once. Causal tiles stop at the diagonal and window tiles
// start at the first key in the window; if some row of the tile sees no key
// at all, the CTA walks every key so that row averages all of them. CTAs are
// issued last q tile first, so the longest causal walks start first. The
// scale is applied to the f32 scores after the product (hd^-0.5 is not a
// power of two at hd 128). In bf16, P is rounded to bf16 before P.V (the row
// sum l stays in f32): one more bf16 rounding than the reference, a few 1e-3
// of each output row's norm (the tests allow 1e-2); S stays in registers,
// since the C layout of Q.K^T is the A layout of P.V. Four variants, which
// the wrapper picks from the dtype and hd alone:
//
// - wgmma (bf16, hd 64 or 128, the models): 128-row q tiles, 384 threads.
//   A producer warp loads the q tile once and then K and V tiles of 128 keys
//   into a 2-stage ring with TMA (4-D tensor maps over (hd, heads, t, b), so
//   rows past tq or tk of a batch row load as zeros; at hd 128 a row is two
//   64-wide boxes, the 128-byte swizzle span), signalled through mbarriers,
//   K and V on separate barriers so Q.K^T starts before V has landed. Two
//   consumer warpgroups of 64 query rows each (setmaxnreg: 232 registers,
//   the producer 40) run S = Q.K^T as an SS wgmma.m64n128k16 with both
//   operands K-major, the masked online softmax on the f32 accumulator
//   (tiles that every row sees in full skip the mask), and O += P.V as an
//   RS wgmma with P from registers and V read MN-major through the
//   transpose bit: no transposed copy of V. Within a warpgroup the
//   softmax runs between the two products; the two warpgroups interleave
//   on the tensor cores. Tiles are released to the producer once P.V has
//   finished reading them.
// - wgmma_hd256 (bf16, hd 256): the same ring and products with one
//   consumer warpgroup of 64 query rows and 64-key tiles (160 threads; see
//   namespace wg256 for why), S as an SS wgmma.m64n64k16 and O += P.V as two
//   RS wgmma.m64n128k16, one per half of hd.
// - mma (bf16, hd 16, the reduced smoke configs): 64-row q tiles, 4 warps
//   of 16 rows on mma.sync.m16n8k16, 64-key tiles loaded synchronously,
//   V stored transposed in shared memory for the B operand.
// - fma (f32): plain FP32 FMAs (TF32 stays off), 64-row q tiles, 256
//   threads in a 16 x 16 grid, 4 x 2 scores and 4 x hd/16 outputs per
//   thread, P through shared memory.
//
// The mma and fma variants are single-buffered and synchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;  // the reference's NEG_INF
constexpr int BQ = 64;             // query rows per CTA (mma and fma)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int tq, tk, nq, nkv, q_offset, causal, window;  // window 0 = none
  float scale;
};

// Keys [lo, hi] (inclusive) that query position p may see.
__device__ __forceinline__ void key_range(const Params& P, int p, int& lo,
                                          int& hi) {
  lo = P.window > 0 ? max(0, p - P.window + 1) : 0;
  hi = P.causal ? min(p, P.tk - 1) : P.tk - 1;
}

// kv tiles [t0, t1] of the CTA whose valid query rows are q0..q0+rows-1.
// lo and hi never decrease with p, and a row sees no key only at the ends
// (p < 0 under causal, p >= tk - 1 + window under a window), so the first
// and last rows decide both the range and whether a row sees nothing, in
// which case every key is walked.
__device__ __forceinline__ void tile_range(const Params& P, int q0, int rows,
                                           int bk, int& t0, int& t1) {
  int lo_f, hi_f, lo_l, hi_l;
  key_range(P, P.q_offset + q0, lo_f, hi_f);
  key_range(P, P.q_offset + q0 + rows - 1, lo_l, hi_l);
  if (lo_f > hi_f || lo_l > hi_l) {
    t0 = 0;
    t1 = (P.tk - 1) / bk;
  } else {
    t0 = lo_f / bk;
    t1 = hi_l / bk;
  }
}

// The score of query position p against key j, from the raw product x.
__device__ __forceinline__ float masked_score(const Params& P, float x, int p,
                                              int j) {
  if (j >= P.tk) return -CUDART_INF_F;  // absent, weight exactly 0
  if ((P.causal && j > p) || (P.window > 0 && j <= p - P.window))
    return NEG_BIG;
  return x * P.scale;
}

// --------------------------------------------------- bf16, hd 16, mma.sync

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int BK16 = 64;       // keys per tile
constexpr int THREADS16 = 128;

template <int HD>
constexpr int smem_bf16() {
  return (BQ * (HD + 8) + BK16 * (HD + 8) + HD * (BK16 + 8)) * 2;
}

template <int HD>
__global__ void __launch_bounds__(THREADS16) flash_fwd_bf16(Params P) {
  using bf16 = __nv_bfloat16;
  constexpr int QS = HD + 8, KS = HD + 8, VS = BK16 + 8;  // padded rows
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][QS]
  bf16* Ks = Qs + BQ * QS;                       // [BK16][KS]
  bf16* Vt = Ks + BK16 * KS;                     // [HD][VS], V transposed

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int q0 = (static_cast<int>(gridDim.x - 1 - blockIdx.x)) * BQ;
  const int bh = static_cast<int>(blockIdx.y);
  const int bi = bh / P.nq, h = bh % P.nq, kvh = h / (P.nq / P.nkv);
  const int rows = min(BQ, P.tq - q0);
  const size_t q_stride = (size_t)P.nq * HD, kv_stride = (size_t)P.nkv * HD;
  const bf16* qb = static_cast<const bf16*>(P.q) +
                   ((size_t)bi * P.tq + q0) * q_stride + (size_t)h * HD;
  const size_t kv_base = (size_t)bi * P.tk * kv_stride + (size_t)kvh * HD;
  const bf16* kb = static_cast<const bf16*>(P.k) + kv_base;
  const bf16* vb = static_cast<const bf16*>(P.v) + kv_base;

  for (int i = tid; i < BQ * CH; i += THREADS16) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)r * q_stride + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf16* a = Qs + r0 * QS + kk * 16 + tg * 2;
    qf[kk][0] = ld32(a);
    qf[kk][1] = ld32(a + 8 * QS);
    qf[kk][2] = ld32(a + 8);
    qf[kk][3] = ld32(a + 8 * QS + 8);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  const int pos[2] = {P.q_offset + q0 + r0, P.q_offset + q0 + r0 + 8};

  int t0, t1;
  tile_range(P, q0, rows, BK16, t0, t1);
  for (int t = t0; t <= t1; ++t) {
    const int k0 = t * BK16;
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < BK16 * CH; i += THREADS16) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < P.tk)
        val = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kv_stride
                                              + c);
      *reinterpret_cast<uint4*>(Ks + r * KS + c) = val;
    }
    // V transposed; neighbouring threads take neighbouring keys so the
    // 2-byte stores into a row of Vt do not collide on a bank.
    for (int i = tid; i < BK16 * CH; i += THREADS16) {
      const int r = i % BK16, c = (i / BK16) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < P.tk)
        val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kv_stride
                                              + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) Vt[(c + u) * VS + r] = e[u];
    }
    __syncthreads();

    float s[BK16 / 8][4];
#pragma unroll
    for (int n = 0; n < BK16 / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK16 / 8; ++n) {
        const bf16* b = Ks + (n * 8 + g) * KS + kk * 16 + tg * 2;
        mma_bf16(s[n], qf[kk], ld32(b), ld32(b + 8));
      }
    }

    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < BK16 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + n * 8 + tg * 2 + (e & 1);
        s[n][e] = masked_score(P, s[n][e], pos[e >> 1], j);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = __expf(m[rr] - m_new);
      m[rr] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK16 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m[e >> 1]);
        ls[e >> 1] += s[n][e];
      }
    }
    // l is this thread's share of the row sum (alpha is the same on the
    // row's four threads); the shares are added up after the last tile.
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < BK16 / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const bf16* b = Vt + (n * 8 + g) * VS + kc * 16 + tg * 2;
        mma_bf16(o[n], a, ld32(b), ld32(b + 8));
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    l[rr] = fmaxf(l[rr], 1e-30f);
  }
  bf16* ob = static_cast<bf16*>(P.out) +
             ((size_t)bi * P.tq + q0) * q_stride + (size_t)h * HD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * q_stride + n * 8 +
                                         tg * 2) =
          __floats2bfloat162_rn(o[n][2 * rr] / l[rr], o[n][2 * rr + 1] / l[rr]);
    }
  }
}

// ----------------------------------------------- bf16, wgmma + TMA ring

namespace wg {

constexpr int BQ = 128;      // query rows per CTA: 2 consumer warpgroups
constexpr int BKV = 128;     // keys per tile
constexpr int STAGES = 2;    // K/V tiles in flight
constexpr int THREADS = 384;  // 2 consumer warpgroups + the producer's
constexpr int ROW = 128;     // bytes of one swizzled box row (64 bf16)

template <int HD>
struct Smem {
  static constexpr int Q_BYTES = BQ * HD * 2;    // HD / 64 boxes of BQ rows
  static constexpr int KV_BYTES = BKV * HD * 2;  // HD / 64 boxes of BKV rows
  static constexpr int STAGE = 2 * KV_BYTES;     // K, then V
  static constexpr int BARS = 1 + 3 * STAGES;    // Q; K full, V full, empty
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + BARS * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, Params P) {
  using L = Smem<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int CH = HD / 64;  // boxes per row of q, k or v
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = hopper::align1024(smem_raw);
  unsigned char* ring = Qs + L::Q_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring + STAGES * L::STAGE);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  const int tid = static_cast<int>(threadIdx.x);
  const int group = tid / 128;
  const int q0 = (static_cast<int>(gridDim.x - 1 - blockIdx.x)) * BQ;
  const int bh = static_cast<int>(blockIdx.y);
  const int bi = bh / P.nq, h = bh % P.nq, kvh = h / (P.nq / P.nkv);
  const int rows = min(BQ, P.tq - q0);
  int t0, t1;
  tile_range(P, q0, rows, BKV, t0, t1);

  if (tid == 0) {
    hopper::mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (group == 2) {  // producer
    hopper::setmaxnreg_dec<40>();
    if (tid == 256) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      // coordinates (hd, head, t, batch); rows past tq or tk load as zeros
      hopper::mbar_expect_tx(qfull, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        hopper::tma_load_4d(Qs + c * BQ * ROW, &qmap, qfull, 64 * c, h, q0,
                            bi);
      for (int t = t0; t <= t1; ++t) {
        const int i = t - t0, s = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        unsigned char* ks = ring + s * L::STAGE;
        unsigned char* vs = ks + L::KV_BYTES;
        hopper::mbar_expect_tx(&kfull[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_4d(ks + c * BKV * ROW, &kmap, &kfull[s], 64 * c,
                              kvh, t * BKV, bi);
        hopper::mbar_expect_tx(&vfull[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_4d(vs + c * BKV * ROW, &vmap, &vfull[s], 64 * c,
                              kvh, t * BKV, bi);
      }
    }
  } else {  // consumers: warpgroup `group` owns query rows 64 * group ...
    hopper::setmaxnreg_inc<232>();
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int g = lane / 4, tg = lane % 4;
    const int r0 = 64 * group + 16 * warp + g;  // rows r0 and r0 + 8
    const int pos[2] = {P.q_offset + q0 + r0, P.q_offset + q0 + r0 + 8};
    // A tile of keys [k0, k0 + BKV) that every valid row sees in full
    // needs no mask: keys from the last row's first to the first row's last.
    int lo_last, hi_first, unused;
    key_range(P, P.q_offset + q0, unused, hi_first);
    key_range(P, P.q_offset + q0 + rows - 1, lo_last, unused);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    hopper::fence_regs(o);
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
    const unsigned char* qa = Qs + group * 64 * ROW;
    hopper::mbar_wait(qfull, 0);

    for (int t = t0; t <= t1; ++t) {
      const int i = t - t0, s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const unsigned char* ks = ring + s * L::STAGE;
      const unsigned char* vs = ks + L::KV_BYTES;

      // S = Q K^T: both K-major (hd contiguous), 4 k16 steps per box
      float sc[BKV / 2];
      hopper::mbar_wait(&kfull[s], parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int box = kk / 4, col = (kk % 4) * 32;
        hopper::wgmma_m64n128k16_ss<0, 0>(
            sc, hopper::desc_k(qa + box * BQ * ROW + col),
            hopper::desc_k(ks + box * BKV * ROW + col), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      const int k0 = t * BKV;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      if (k0 >= lo_last && k0 + BKV - 1 <= hi_first) {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          sc[e] *= P.scale;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const int j = k0 + 8 * (e / 4) + 2 * tg + (e & 1);
          sc[e] = masked_score(P, sc[e], pos[(e >> 1) & 1], j);
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        }
      }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m[rr], mx[rr]);
        alpha[rr] = __expf(m[rr] - m_new);
        m[rr] = m_new;
      }
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        sc[e] = __expf(sc[e] - m[(e >> 1) & 1]);
        ls[(e >> 1) & 1] += sc[e];
      }
      // l is this thread's share of the row sum, added up after the walk
      l[0] = l[0] * alpha[0] + ls[0];
      l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      // P in bf16: the accumulator's 16 columns of keys kc are the A
      // fragment of the k16 step kc, two to a register
      uint32_t p[BKV / 16][4];
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          p[kc][u] = pack_bf16(sc[8 * kc + 2 * u], sc[8 * kc + 2 * u + 1]);

      // O += P V: V is MN-major (hd contiguous), 64-wide hd atoms one box
      // (BKV rows) apart
      hopper::mbar_wait(&vfull[s], parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        const uint64_t db = hopper::desc_mn(vs + kc * 16 * ROW, BKV * ROW);
        if constexpr (HD == 128)
          hopper::wgmma_m64n128k16_rs<1>(o, p[kc], db, 1);
        else
          hopper::wgmma_m64n64k16_rs<1>(o, p[kc], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      l[rr] = fmaxf(l[rr], 1e-30f);
    }
    const size_t q_stride = (size_t)P.nq * HD;
    bf16* ob = static_cast<bf16*>(P.out) +
               ((size_t)bi * P.tq + q0) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * q_stride +
                                           8 * j + 2 * tg) =
            __floats2bfloat162_rn(o[4 * j + 2 * rr] / l[rr],
                                  o[4 * j + 2 * rr + 1] / l[rr]);
    }
  }
}

template <int HD>
cudaError_t launch(const Params& P, int b, cudaStream_t st) {
  // q as (hd, nq, tq, b) and k, v as (hd, nkv, tk, b), innermost first:
  // boxes of 64 of hd x one head x BQ or BKV positions x one batch row.
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[4] = {HD, (uint64_t)P.nq, (uint64_t)P.tq,
                             (uint64_t)b};
  const uint64_t qstr[3] = {HD * 2, (uint64_t)P.nq * HD * 2,
                            (uint64_t)P.tq * P.nq * HD * 2};
  const uint64_t kvdims[4] = {HD, (uint64_t)P.nkv, (uint64_t)P.tk,
                              (uint64_t)b};
  const uint64_t kvstr[3] = {HD * 2, (uint64_t)P.nkv * HD * 2,
                             (uint64_t)P.tk * P.nkv * HD * 2};
  const uint32_t qbox[4] = {64, 1, BQ, 1}, kvbox[4] = {64, 1, BKV, 1};
  cudaError_t err = hopper::encode_bf16(&qmap, P.q, 4, qdims, qstr, qbox);
  if (err == cudaSuccess)
    err = hopper::encode_bf16(&kmap, P.k, 4, kvdims, kvstr, kvbox);
  if (err == cudaSuccess)
    err = hopper::encode_bf16(&vmap, P.v, 4, kvdims, kvstr, kvbox);
  if (err != cudaSuccess) return err;
  const dim3 grid((P.tq + BQ - 1) / BQ, b * P.nq);
  return hopper::launch(flash_fwd_wgmma<HD>, grid, THREADS, Smem<HD>::SMEM,
                        st, qmap, kmap, vmap, P);
}

}  // namespace wg

// ------------------------------------- bf16, hd 256, wgmma + TMA ring

namespace wg256 {

// hd 256 (recurrentgemma's local layers) does not fit the layout above:
// its O accumulator alone is 128 f32 registers per consumer thread, and
// 128-row q tiles with 128-key stages would need 64 + 2 x 128 KB of
// shared memory. So one consumer warpgroup owns 64 query rows, a producer
// warp streams 64-key K and V tiles through the same 2-stage TMA ring, and
// the CTA has 160 threads and all 255 registers each (no setmaxnreg).
constexpr int HD = 256;
constexpr int BQ = 64;        // query rows per CTA: one consumer warpgroup
constexpr int BKV = 64;       // keys per tile
constexpr int STAGES = 2;
constexpr int THREADS = 160;  // the warpgroup + the producer warp
constexpr int ROW = 128;      // bytes of one swizzled box row (64 bf16)
constexpr int CH = HD / 64;   // boxes per row of q, k or v
constexpr int Q_BYTES = BQ * HD * 2;    // 32 KB
constexpr int KV_BYTES = BKV * HD * 2;  // 32 KB
constexpr int STAGE = 2 * KV_BYTES;     // K, then V
constexpr int BARS = 1 + 3 * STAGES;    // Q; K full, V full, empty
constexpr int SMEM = Q_BYTES + STAGES * STAGE + BARS * 8 + 1024;

__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_hd256(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, Params P) {
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = hopper::align1024(smem_raw);
  unsigned char* ring = Qs + Q_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  const int tid = static_cast<int>(threadIdx.x);
  const int q0 = (static_cast<int>(gridDim.x - 1 - blockIdx.x)) * BQ;
  const int bh = static_cast<int>(blockIdx.y);
  const int bi = bh / P.nq, h = bh % P.nq, kvh = h / (P.nq / P.nkv);
  const int rows = min(BQ, P.tq - q0);
  int t0, t1;
  tile_range(P, q0, rows, BKV, t0, t1);

  if (tid == 0) {
    hopper::mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp
    if (tid == 128) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::mbar_expect_tx(qfull, Q_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        hopper::tma_load_4d(Qs + c * BQ * ROW, &qmap, qfull, 64 * c, h, q0,
                            bi);
      for (int t = t0; t <= t1; ++t) {
        const int i = t - t0, s = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        unsigned char* ks = ring + s * STAGE;
        unsigned char* vs = ks + KV_BYTES;
        hopper::mbar_expect_tx(&kfull[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_4d(ks + c * BKV * ROW, &kmap, &kfull[s], 64 * c,
                              kvh, t * BKV, bi);
        hopper::mbar_expect_tx(&vfull[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_4d(vs + c * BKV * ROW, &vmap, &vfull[s], 64 * c,
                              kvh, t * BKV, bi);
      }
    }
    return;
  }

  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tg = lane % 4;
  const int r0 = 16 * warp + g;  // rows r0 and r0 + 8
  const int pos[2] = {P.q_offset + q0 + r0, P.q_offset + q0 + r0 + 8};
  int lo_last, hi_first, unused;
  key_range(P, P.q_offset + q0, unused, hi_first);
  key_range(P, P.q_offset + q0 + rows - 1, lo_last, unused);

  // O in two halves of hd: o[half][4j + e] is row r0 + 8 * (e >> 1),
  // column 128 * half + 8j + 2 * tg + (e & 1)
  float o[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[0][i] = o[1][i] = 0.f;
  hopper::fence_regs(o[0]);
  hopper::fence_regs(o[1]);
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(qfull, 0);

  for (int t = t0; t <= t1; ++t) {
    const int i = t - t0, s = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    const unsigned char* ks = ring + s * STAGE;
    const unsigned char* vs = ks + KV_BYTES;

    // S = Q K^T (64 x 64): both K-major, 4 k16 steps per 64-wide box
    float sc[BKV / 2];
    hopper::mbar_wait(&kfull[s], parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk / 4, col = (kk % 4) * 32;
      hopper::wgmma_m64n64k16_ss<0, 0>(
          sc, hopper::desc_k(Qs + box * BQ * ROW + col),
          hopper::desc_k(ks + box * BKV * ROW + col), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    const int k0 = t * BKV;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (k0 >= lo_last && k0 + BKV - 1 <= hi_first) {
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        sc[e] *= P.scale;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        const int j = k0 + 8 * (e / 4) + 2 * tg + (e & 1);
        sc[e] = masked_score(P, sc[e], pos[(e >> 1) & 1], j);
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      }
    }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = __expf(m[rr] - m_new);
      m[rr] = m_new;
    }
#pragma unroll
    for (int e = 0; e < BKV / 2; ++e) {
      sc[e] = __expf(sc[e] - m[(e >> 1) & 1]);
      ls[(e >> 1) & 1] += sc[e];
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      o[0][e] *= alpha[(e >> 1) & 1];
      o[1][e] *= alpha[(e >> 1) & 1];
    }
    uint32_t p[BKV / 16][4];
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        p[kc][u] = pack_bf16(sc[8 * kc + 2 * u], sc[8 * kc + 2 * u + 1]);

    // O += P V: V MN-major, hd in two 128-wide halves of two boxes each
    hopper::mbar_wait(&vfull[s], parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint64_t db = hopper::desc_mn(
            vs + half * 2 * BKV * ROW + kc * 16 * ROW, BKV * ROW);
        hopper::wgmma_m64n128k16_rs<1>(o[half], p[kc], db, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o[0]);
    hopper::fence_regs(o[1]);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    l[rr] = fmaxf(l[rr], 1e-30f);
  }
  const size_t q_stride = (size_t)P.nq * HD;
  bf16* ob = static_cast<bf16*>(P.out) +
             ((size_t)bi * P.tq + q0) * q_stride + (size_t)h * HD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    if (r >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * q_stride +
                                           128 * half + 8 * j + 2 * tg) =
            __floats2bfloat162_rn(o[half][4 * j + 2 * rr] / l[rr],
                                  o[half][4 * j + 2 * rr + 1] / l[rr]);
  }
}

cudaError_t launch(const Params& P, int b, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[4] = {HD, (uint64_t)P.nq, (uint64_t)P.tq,
                             (uint64_t)b};
  const uint64_t qstr[3] = {HD * 2, (uint64_t)P.nq * HD * 2,
                            (uint64_t)P.tq * P.nq * HD * 2};
  const uint64_t kvdims[4] = {HD, (uint64_t)P.nkv, (uint64_t)P.tk,
                              (uint64_t)b};
  const uint64_t kvstr[3] = {HD * 2, (uint64_t)P.nkv * HD * 2,
                             (uint64_t)P.tk * P.nkv * HD * 2};
  const uint32_t qbox[4] = {64, 1, BQ, 1}, kvbox[4] = {64, 1, BKV, 1};
  cudaError_t err = hopper::encode_bf16(&qmap, P.q, 4, qdims, qstr, qbox);
  if (err == cudaSuccess)
    err = hopper::encode_bf16(&kmap, P.k, 4, kvdims, kvstr, kvbox);
  if (err == cudaSuccess)
    err = hopper::encode_bf16(&vmap, P.v, 4, kvdims, kvstr, kvbox);
  if (err != cudaSuccess) return err;
  const dim3 grid((P.tq + BQ - 1) / BQ, b * P.nq);
  return hopper::launch(flash_fwd_wgmma_hd256, grid, THREADS, SMEM, st, qmap,
                        kmap, vmap, P);
}

}  // namespace wg256

// ------------------------------------------------------------ f32, FMAs

constexpr int BK32 = 32;       // keys per tile
constexpr int THREADS32 = 256;  // 16 x 16

template <int HD>
constexpr int smem_f32() {
  return (BQ * (HD + 1) + BK32 * (HD + 1) + BK32 * HD + BQ * (BK32 + 1)) * 4;
}

template <int HD>
__global__ void __launch_bounds__(THREADS32) flash_fwd_f32(Params P) {
  constexpr int QS = HD + 1, KS = HD + 1, PS = BK32 + 1;  // padded rows
  constexpr int TO = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][QS]
  float* Ks = Qs + BQ * QS;    // [BK32][KS]
  float* Vs = Ks + BK32 * KS;  // [BK32][HD]
  float* Ps = Vs + BK32 * HD;  // [BQ][PS]

  const int tid = static_cast<int>(threadIdx.x);
  const int tx = tid % 16, ty = tid / 16;  // rows ty + 16i, columns tx + 16j
  const int q0 = (static_cast<int>(gridDim.x - 1 - blockIdx.x)) * BQ;
  const int bh = static_cast<int>(blockIdx.y);
  const int bi = bh / P.nq, h = bh % P.nq, kvh = h / (P.nq / P.nkv);
  const int rows = min(BQ, P.tq - q0);
  const size_t q_stride = (size_t)P.nq * HD, kv_stride = (size_t)P.nkv * HD;
  const float* qb = static_cast<const float*>(P.q) +
                    ((size_t)bi * P.tq + q0) * q_stride + (size_t)h * HD;
  const size_t kv_base = (size_t)bi * P.tk * kv_stride + (size_t)kvh * HD;
  const float* kb = static_cast<const float*>(P.k) + kv_base;
  const float* vb = static_cast<const float*>(P.v) + kv_base;

  for (int i = tid; i < BQ * HD; i += THREADS32) {
    const int r = i / HD, d = i % HD;
    Qs[r * QS + d] = r < rows ? qb[(size_t)r * q_stride + d] : 0.f;
  }

  float acc[4][TO], m[4], l[4];
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
    pos[i] = P.q_offset + q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;
  }

  int t0, t1;
  tile_range(P, q0, rows, BK32, t0, t1);
  for (int t = t0; t <= t1; ++t) {
    const int k0 = t * BK32;
    __syncthreads();  // Qs written; the previous tile has been consumed
    for (int i = tid; i < BK32 * HD; i += THREADS32) {
      const int r = i / HD, d = i % HD;
      const bool ok = k0 + r < P.tk;
      const size_t off = (size_t)(k0 + r) * kv_stride + d;
      Ks[r * KS + d] = ok ? kb[off] : 0.f;
      Vs[r * HD + d] = ok ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = masked_score(P, s[i][j], pos[i], k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)  // the row's 16 threads
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = __expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < TO; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK32; ++c) {
      float p[4], vv[TO];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < TO; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
      }
    }
  }

  float* ob = static_cast<float*>(P.out) +
              ((size_t)bi * P.tq + q0) * q_stride + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TO; ++j)
      ob[(size_t)r * q_stride + tx + 16 * j] = acc[i][j] / den;
  }
}

enum Variant { FMA = 0, MMA = 1, WGMMA = 2, WGMMA_HD256 = 3 };  // VARIANTS

}  // namespace

// Launches `variant` on `stream` and returns the CUDA error (0 on success).
// q, k, v and out are contiguous device tensors in the layout above,
// 16-byte aligned; scale is hd^-0.5 rounded to f32 by the caller, as the
// reference rounds it. The caller has checked shapes, dtypes, that the
// variant takes them (fma: f32, hd 16, 64, 128 or 256; mma: bf16, hd 16;
// wgmma: bf16, hd 64 or 128; wgmma_hd256: bf16, hd 256) and that tq, tk >= 1,
// nq % nkv == 0 and
// b * nq <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int tq,
                                      int tk, int nq, int nkv, int hd,
                                      int q_offset, int causal, int window,
                                      float scale, int variant, void* stream) {
  Params p{q, k, v, out, tq, tk, nq, nkv, q_offset, causal, window, scale};
  const dim3 grid((tq + BQ - 1) / BQ, b * nq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == WGMMA) {
    if (hd == 64) err = wg::launch<64>(p, b, st);
    if (hd == 128) err = wg::launch<128>(p, b, st);
  } else if (variant == WGMMA_HD256) {
    if (hd == 256) err = wg256::launch(p, b, st);
  } else if (variant == MMA) {
    if (hd == 16)
      err = hopper::launch(flash_fwd_bf16<16>, grid, THREADS16,
                           smem_bf16<16>(), st, p);
  } else if (variant == FMA) {
    if (hd == 16)
      err = hopper::launch(flash_fwd_f32<16>, grid, THREADS32, smem_f32<16>(),
                           st, p);
    if (hd == 64)
      err = hopper::launch(flash_fwd_f32<64>, grid, THREADS32, smem_f32<64>(),
                           st, p);
    if (hd == 128)
      err = hopper::launch(flash_fwd_f32<128>, grid, THREADS32,
                           smem_f32<128>(), st, p);
    if (hd == 256)
      err = hopper::launch(flash_fwd_f32<256>, grid, THREADS32,
                           smem_f32<256>(), st, p);
  }
  return static_cast<int>(err);
}
