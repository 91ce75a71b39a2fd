// Block-gathered XᵀG (the sampled weight gradient of rsc_matmul), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_matmul.py:
// gather_matmul (its pallas_call is at line 70). It computes the same
// function:
//
//   out = sum_t X[idx[t]*bk : +bk, :]^T @ G[idx[t]*bk : +bk, :]
//
// x is (n, m), g is (n, q), both token-major and contiguous, of one dtype
// (f32 or bf16); idx holds k_sel >= 1 selected bk-row token blocks (sorted,
// int32); bk is a multiple of 32 (the models use 128, the smoke tests 32);
// n % bk == 0; any m and q. The sum is taken in f32 and written once, cast
// to x's dtype. The gathered rows of X and G are never materialised: the K
// loop of the product walks idx.
//
// What bounds it on an H100 SXM: per launch it does 2 * k_sel * bk * m * q
// FLOP against reading the selected rows of x and g once and writing the
// output once. At the qwen3-1.7b training shape (8,192 tokens per
// microbatch, bk 128, keep 0.5: k_sel 32; m 2048, q 6144 for gate/up and
// the transpose for down) that is 1.03e11 FLOP against 92 MB: operations
// bound (0.104 ms at 989 TFLOP/s bf16; 0.028 ms of bytes at 3.35 TB/s).
//
// Design. The TPU kernel walks an (m tile, q tile, selected block) grid with
// the block axis innermost and keeps the (bm, bq) f32 accumulator in VMEM.
// Here one CTA owns one output tile, loops over the selected blocks itself
// with the accumulator in registers, and writes its tile once: no split-K,
// no atomics, so the result does not depend on scheduling. Block ids are not
// checked here: the public wrapper checks them on the host, and
// rsc_matmul's top-k ids are in range by construction. Three variants, which
// the wrapper picks from the dtype and the widths alone:
//
// - wgmma (bf16, m % 8 == 0 and q % 8 == 0, the models' widths): 128 x 256
//   output tiles, 384 threads. A producer warp walks idx and, for each
//   stage of KT tokens (64, or 32 when bk is not a multiple of 64), loads
//   the X box (KT tokens x 128 columns of m) and the G box (KT x 256
//   columns of q) starting at token idx[t] * bk + s with TMA into a ring of
//   256 tokens (192 KB), 128-byte swizzled, signalled through mbarriers.
//   Both boxes are token-major, so A = X^T and B = G are MN-major operands,
//   which wgmma's transpose bits read as they lie: no transposed copy. Two
//   consumer warpgroups of 64 rows of m each run wgmma.m64n256k16 with f32
//   accumulators in registers (setmaxnreg gives them 232 registers, the
//   producer 40) and keep one stage's products in flight while releasing
//   the one before. TMA zero-fills columns past m and q; the epilogue
//   writes bf16 pairs straight from the accumulators. 128 x 256 tiles give
//   384 tiles at both qwen3-1.7b shapes (2.9 waves on 132 SMs) and read
//   each selected token's bytes 1/128 + 1/256 times per output element, the
//   least shared-memory traffic per FLOP one CTA of 2 warpgroups can have.
// - mma (bf16, ragged widths): 128 x 128 tiles, 8 warps of 32 x 64 each,
//   mma.sync.m16n8k16, 32 tokens staged at a time and stored transposed in
//   shared memory (rows padded to 40 elements), one element a thread.
// - fma (f32): 64 x 64 tiles on plain FP32 FMAs (TF32 stays off), 256
//   threads in a 16 x 16 grid with 4 x 4 outputs each; the slabs keep their
//   token-major layout.
//
// The mma and fma variants are single-buffered and synchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KC = 32;  // tokens staged per step; bk is a multiple of it

struct Params {
  const void* x;
  const void* g;
  const int* idx;
  void* out;
  int n, m, q, k_sel, bk;
};

// The first token of selected block t (an id in [0, n / bk)).
__device__ __forceinline__ int block_start(const Params& P, int t) {
  return P.idx[t] * P.bk;
}

// ----------------------------------------------- bf16, wgmma + TMA ring

namespace wg {

constexpr int BM = 128, BN = 256;  // output tile: rows of m x columns of q
constexpr int THREADS = 384;       // 2 consumer warpgroups + the producer's
constexpr int RING = 256;          // tokens in flight: STAGES * KT
constexpr int ROW = 128;           // bytes of one swizzled box row (64 bf16)

template <int KT>
struct Ring {
  static constexpr int STAGES = RING / KT;
  static constexpr int BOX = KT * ROW;           // one 64-column box
  static constexpr int A_BYTES = (BM / 64) * BOX;
  static constexpr int STAGE = (BM / 64 + BN / 64) * BOX;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
    gather_mm_wgmma(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap gmap, const int* idx,
                    bf16* out, int m, int q, int k_sel, int bk) {
  using R = Ring<KT>;
  constexpr int S = R::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * R::STAGE);
  uint64_t* empty = full + S;

  const int tid = static_cast<int>(threadIdx.x);
  const int group = tid / 128;
  const int q0 = static_cast<int>(blockIdx.x) * BN;
  const int m0 = static_cast<int>(blockIdx.y) * BM;
  const int per_block = bk / KT;
  const int steps = k_sel * per_block;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (group == 2) {  // producer
    hopper::setmaxnreg_dec<40>();
    if (tid == 256) {
      hopper::prefetch_map(&xmap);
      hopper::prefetch_map(&gmap);
      for (int i = 0; i < steps; ++i) {
        const int s = i % S;
        if (i >= S) hopper::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        const int tok = __ldg(idx + i / per_block) * bk + (i % per_block) * KT;
        unsigned char* st = ring + s * R::STAGE;
        hopper::mbar_expect_tx(&full[s], R::STAGE);
#pragma unroll
        for (int c = 0; c < BM / 64; ++c)
          hopper::tma_load_2d(st + c * R::BOX, &xmap, &full[s], m0 + 64 * c,
                              tok);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          hopper::tma_load_2d(st + R::A_BYTES + c * R::BOX, &gmap, &full[s],
                              q0 + 64 * c, tok);
      }
    }
  } else {  // consumers: warpgroup `group` owns rows m0 + 64 * group ...
    hopper::setmaxnreg_inc<232>();
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    hopper::fence_regs(d);
    const int lane = tid % 32;
    for (int i = 0; i < steps; ++i) {
      const int s = i % S;
      hopper::mbar_wait(&full[s], (i / S) & 1);
      const unsigned char* a = ring + s * R::STAGE + group * R::BOX;
      const unsigned char* b = ring + s * R::STAGE + R::A_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        hopper::wgmma_m64n256k16_ss<1, 1>(
            d, hopper::desc_mn(a + kk * 16 * ROW, R::BOX),
            hopper::desc_mn(b + kk * 16 * ROW, R::BOX), 1);
      hopper::wgmma_commit();
      // stage i's products stay in flight; stage i - 1's have finished
      hopper::wgmma_wait<1>();
      if (i > 0 && lane == 0) hopper::mbar_arrive(&empty[(i - 1) % S]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(d);

    const int warp = (tid % 128) / 32;
    const int row = m0 + 64 * group + 16 * warp + lane / 4;
    const int col0 = q0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      if (col >= q) continue;  // q % 8 == 0: a pair is all in or all out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < m)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * q + col) =
              __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int KT>
cudaError_t launch(const Params& P, cudaStream_t st) {
  // X as (n rows, m columns) and G as (n, q): boxes of 64 columns x KT
  // tokens; columns past m or q load as zeros.
  CUtensorMap xmap, gmap;
  const uint32_t box[2] = {64, KT};
  const uint64_t xdims[2] = {(uint64_t)P.m, (uint64_t)P.n};
  const uint64_t xstride[1] = {(uint64_t)P.m * 2};
  const uint64_t gdims[2] = {(uint64_t)P.q, (uint64_t)P.n};
  const uint64_t gstride[1] = {(uint64_t)P.q * 2};
  cudaError_t err = hopper::encode_bf16(&xmap, P.x, 2, xdims, xstride, box);
  if (err == cudaSuccess)
    err = hopper::encode_bf16(&gmap, P.g, 2, gdims, gstride, box);
  if (err != cudaSuccess) return err;
  const dim3 grid((P.q + BN - 1) / BN, (P.m + BM - 1) / BM);
  return hopper::launch(gather_mm_wgmma<KT>, grid, THREADS, Ring<KT>::SMEM,
                        st, xmap, gmap, P.idx, static_cast<bf16*>(P.out),
                        P.m, P.q, P.k_sel, P.bk);
}

}  // namespace wg

// ------------------------------------------- bf16, ragged widths, mma.sync

constexpr int BT = 128;       // output tile: BT rows of m x BT columns of q
constexpr int TS = KC + 8;    // padded row of a transposed slab
constexpr int THREADS16 = 256;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// dst[c * TS + r] = src[(tok0 + r) * ld + c0 + c] for r < KC, c < BT, and 0
// for columns c0 + c >= ld.
__device__ __forceinline__ void stage_t(const bf16* src, int ld, int tok0,
                                        int c0, bf16* dst, int tid) {
  for (int i = tid; i < KC * BT; i += THREADS16) {
    const int r = i / BT, c = i % BT;
    dst[c * TS + r] = c0 + c < ld ? src[(size_t)(tok0 + r) * ld + c0 + c]
                                  : __float2bfloat16(0.f);
  }
}

__global__ void __launch_bounds__(THREADS16) gather_mm_bf16(Params P) {
  __shared__ __align__(16) bf16 Xt[BT * TS];  // Xt[i][k] = X[tok0 + k][m0 + i]
  __shared__ __align__(16) bf16 Gt[BT * TS];  // Gt[j][k] = G[tok0 + k][q0 + j]

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 64;  // the warp's corner
  const int q0 = static_cast<int>(blockIdx.x) * BT;
  const int m0 = static_cast<int>(blockIdx.y) * BT;
  const bf16* X = static_cast<const bf16*>(P.x);
  const bf16* G = static_cast<const bf16*>(P.g);

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  for (int t = 0; t < P.k_sel; ++t) {
    const int start = block_start(P, t);
    for (int s = 0; s < P.bk; s += KC) {
      __syncthreads();  // the previous slabs have been consumed
      stage_t(X, P.m, start + s, m0, Xt, tid);
      stage_t(G, P.q, start + s, q0, Gt, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const bf16* pa = Xt + (wm + mi * 16 + g) * TS + kk + tg * 2;
          a[mi][0] = ld32(pa);
          a[mi][1] = ld32(pa + 8 * TS);
          a[mi][2] = ld32(pa + 8);
          a[mi][3] = ld32(pa + 8 * TS + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const bf16* pb = Gt + (wn + ni * 8 + g) * TS + kk + tg * 2;
          const uint32_t b0 = ld32(pb), b1 = ld32(pb + 8);
          mma_bf16(acc[0][ni], a[0], b0, b1);
          mma_bf16(acc[1][ni], a[1], b0, b1);
        }
      }
    }
  }

  bf16* out = static_cast<bf16*>(P.out);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = m0 + wm + mi * 16 + g + 8 * rr;
      if (row >= P.m) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = q0 + wn + ni * 8 + tg * 2;
        const float v0 = acc[mi][ni][2 * rr], v1 = acc[mi][ni][2 * rr + 1];
        bf16* o = out + (size_t)row * P.q + col;
        if (col < P.q) o[0] = __float2bfloat16(v0);
        if (col + 1 < P.q) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

// ------------------------------------------------------------ f32, FMAs

constexpr int BT32 = 64;
constexpr int THREADS32 = 256;  // 16 x 16

__global__ void __launch_bounds__(THREADS32) gather_mm_f32(Params P) {
  __shared__ float Xs[KC][BT32];  // Xs[k][i] = X[tok0 + k][m0 + i]
  __shared__ float Gs[KC][BT32];  // Gs[k][j] = G[tok0 + k][q0 + j]

  const int tid = static_cast<int>(threadIdx.x);
  const int tx = tid % 16, ty = tid / 16;  // rows ty + 16a, columns tx + 16b
  const int q0 = static_cast<int>(blockIdx.x) * BT32;
  const int m0 = static_cast<int>(blockIdx.y) * BT32;
  const float* X = static_cast<const float*>(P.x);
  const float* G = static_cast<const float*>(P.g);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int t = 0; t < P.k_sel; ++t) {
    const int start = block_start(P, t);
    for (int s = 0; s < P.bk; s += KC) {
      const size_t tok0 = (size_t)(start + s);
      __syncthreads();  // the previous slabs have been consumed
      for (int i = tid; i < KC * BT32; i += THREADS32) {
        const int r = i / BT32, c = i % BT32;
        Xs[r][c] = m0 + c < P.m ? X[(tok0 + r) * P.m + m0 + c] : 0.f;
        Gs[r][c] = q0 + c < P.q ? G[(tok0 + r) * P.q + q0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = Xs[k][ty + 16 * u];
          b[u] = Gs[k][tx + 16 * u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
      }
    }
  }

  float* out = static_cast<float*>(P.out);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = m0 + ty + 16 * u;
    if (row >= P.m) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int col = q0 + tx + 16 * v;
      if (col < P.q) out[(size_t)row * P.q + col] = acc[u][v];
    }
  }
}

enum Variant { FMA = 0, MMA = 1, WGMMA = 2 };  // the wrapper's VARIANTS

}  // namespace

// Launches `variant` on `stream` and returns the CUDA error (0 on success).
// x, g and out are contiguous device tensors in the layout above, 16-byte
// aligned, and idx an int32 device array of k_sel ids in [0, n / bk). The
// caller has checked shapes and dtypes, that the variant takes them (fma:
// f32; mma: bf16; wgmma: bf16 with m % 8 == 0 and q % 8 == 0), that
// k_sel >= 1, m, q >= 1, bk % 32 == 0, n % bk == 0 and that the grid fits
// (ceil(m / 128) <= 65535).
extern "C" int gather_matmul_launch(const void* x, const void* g,
                                    const void* idx, void* out, int n, int m,
                                    int q, int k_sel, int bk, int variant,
                                    void* stream) {
  Params p{x, g, static_cast<const int*>(idx), out, n, m, q, k_sel, bk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case WGMMA:
      if (m % 8 || q % 8) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(bk % 64 ? wg::launch<32>(p, st)
                                      : wg::launch<64>(p, st));
    case MMA: {
      const dim3 grid((q + BT - 1) / BT, (m + BT - 1) / BT);
      gather_mm_bf16<<<grid, THREADS16, 0, st>>>(p);
      break;
    }
    case FMA: {
      const dim3 grid((q + BT32 - 1) / BT32, (m + BT32 - 1) / BT32);
      gather_mm_f32<<<grid, THREADS32, 0, st>>>(p);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
