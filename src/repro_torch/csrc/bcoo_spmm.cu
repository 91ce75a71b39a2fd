// Row-segmented block-COO SpMM with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bcoo_spmm.py:bcoo_spmm
// (its pallas_call is at line 164). It computes the same function:
//
//   out[r*bm:(r+1)*bm, c] = epi( sum_{s in [row_ptr[r], row_ptr[r+1])}
//                                blocks[sel[s]] @ h[col_ids[s]*bk:+bk, c] )
//   epi(y) = relu?( y + bias[c] + residual[r*bm:(r+1)*bm, c] )
//
// with f32 accumulation, inputs in f32 or bf16, the output in h's dtype and
// no atomics: the same inputs give bit-equal outputs. An empty segment
// yields epi(0). Entries whose sel equals `sentinel` (the all-zero padding
// tile) add nothing and are skipped; a partition's padding piles up at its
// last row block.
//
// What bounds it on an H100 SXM (memory 3.35 TB/s): per real tile it reads
// the (bm, bk) tile once and a (bk, d) slab of h (the slabs of a partition
// fit the 50 MB L2), against 2*bm*bk*d FLOP. At bm = bk = 128, f32, the
// main path's heaviest partition (10,816 tiles, 709 MB) is bytes bound at
// d = 41 (0.21 ms) and operations bound at d = 256: 9.1e10 FLOP, which the
// f32 variant runs as three TF32 products (3 x 9.1e10 at 495 TFLOP/s:
// 0.55 ms; 1.35 ms on the FP32 pipes).
//
// Design. The TPU kernel walks one output tile per step of a sequential
// grid into a VMEM accumulator. Here 132 SMs run CTAs in parallel, and a
// GCN partition has few row blocks (62) with long segments (~180 tiles), so
// the work is cut three ways:
//
// - Split segments. The CTA grid is (row block, chunk, column tile), column
//   tile fastest, so the CTAs that read one tile run side by side and the
//   second read hits L2. `chunks` comes from the wrapper (static shapes and
//   the SM count; 1 for short segments); chunk j of row r walks the j-th of
//   `chunks` equal cuts of [row_ptr[r], row_ptr[r+1]), found from row_ptr on
//   the card (no host sync). With one chunk the CTA applies the epilogue;
//   with more, each writes its f32 partial tile into a workspace and a
//   second kernel sums the chunks in order (0, 1, ...) and applies the
//   epilogue once.
// - An asynchronous ring. Every thread starts cp.async copies (LDGSTS) of
//   the next (bm x 32) slice of tile sel[s] and (32 x BN) slice of slab
//   col_ids[s] into a ring of 4-8 stages while the CTA computes on the
//   stage that has arrived (one __syncthreads per stage). Each warp finds
//   the next real entry with one 32-wide load and a ballot, so a run of
//   1,500 sentinels costs ~50 loads. K past bk and columns past the column
//   tile are zero-filled by the copies.
// - Tensor cores (mma.sync, HMMA). f32 ("tf32x3"): each operand is split
//   as x = big + small, both TF32, and the products small*big + big*small
//   + big*big of a stage go into a fresh accumulator that is added to the
//   running sum in f32 with rounding once per stage. The tensor core sums
//   with truncation, so a segment of ~180 tiles summed in its accumulator
//   alone drifts far past FP32's error (chip_smoke.py holds the kernel and
//   the f32 plain version against an f64 one); one-pass TF32 is not used. bf16 ("mma"):
//   m16n8k16 with the slab read through ldmatrix.trans. 8 warps own a
//   128 x BN tile of 16x8 fragments with f32 accumulators: BN = 48 or 64
//   when the column tile bd <= 48 or <= 64 (two CTAs per SM), else 128
//   (one CTA per SM: its two sets of accumulators need more than 128
//   registers a thread).
//
// `fma` is the first port's kernel (FP32 FMAs, one CTA per (row block, <= 64
// columns), synchronous staging), kept for bk not a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Args {
  const void* blocks;  // (S + 1, bm, bk)
  const int* sel;      // (s_pad,)
  const int* col_ids;  // (s_pad,)
  const int* row_ptr;  // (n_row_blocks + 1,)
  const void* h;       // (n_cols, d)
  const void* bias;    // (d,) or null
  const void* residual;  // (n_row_blocks * bm, d) or null
  void* out;             // (n_row_blocks * bm, d)
  float* ws;             // (chunks, n_row_blocks * bm, d) when chunks > 1
  int n_row_blocks, bm, bk, d, bd, sentinel, relu, chunks;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// out[i] = epi(y) for the element i = row * d + col.
template <typename T>
__device__ __forceinline__ void finish(const Args& P, size_t i, int col,
                                       float y) {
  if (P.bias != nullptr) y += to_f32(static_cast<const T*>(P.bias)[col]);
  if (P.residual != nullptr) y += to_f32(static_cast<const T*>(P.residual)[i]);
  if (P.relu) y = y < 0.f ? 0.f : y;  // NaN passes through, as in torch
  store(static_cast<T*>(P.out) + i, y);
}

// ------------------------------------------------ tensor cores, cp.async

namespace tc {

constexpr int BM = 128;       // rows of the CTA tile (bm <= BM)
constexpr int KC = 32;        // depth of one ring stage
constexpr int THREADS = 256;  // 8 warps
constexpr int SMEM_SM = 220 * 1024;  // the ring's share of an SM

// BN = 48 or 64 tiles (narrow layers: more bytes than products) run two
// CTAs of 128 registers a thread on an SM; BN = 128 tiles one CTA with up
// to 255 registers, which the per-stage accumulators need.
template <typename T, int BN>
struct Tile {
  static constexpr int CTAS = BN <= 64 ? 2 : 1;  // CTAs per SM
  static constexpr int VEC = 16 / sizeof(T);  // elements of one 16 B copy
  // Padded rows: the fragment loads below hit 32 distinct banks.
  static constexpr int LDA = KC + VEC;
  static constexpr int LDB = BN + 8;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + KC * LDB;
  static constexpr int STAGE = STAGE_ELEMS * static_cast<int>(sizeof(T));
  static constexpr int STAGES =
      SMEM_SM / CTAS / STAGE < 8 ? SMEM_SM / CTAS / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE;
  static constexpr int WN = BN == 48 ? 1 : BN / 32, WM = 8 / WN;  // warps
  static constexpr int MF = BM / WM / 16;  // 16-row fragments of a warp
  static constexpr int NF = BN / WN / 8;   // 8-column fragments of a warp
  static_assert(STAGES >= 2, "the ring needs two stages");
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_elem(float* dst, const float* src,
                                        bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// A bf16 element is below cp.async's 4-byte grain: copy it synchronously
// (only for ragged bf16 widths, never on the main path).
__device__ __forceinline__ void cp_elem(bf16* dst, const bf16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first entry in [s, hi) whose tile is not the sentinel, or hi. Each
// warp reads 32 ids at once, so a run of padding costs one load per 32.
__device__ __forceinline__ int next_entry(const int* sel, int s, int hi,
                                          int sentinel) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  for (; s < hi; s += 32) {
    const int i = s + lane;
    const unsigned real =
        __ballot_sync(0xffffffffu, i < hi && __ldg(sel + i) != sentinel);
    if (real) return s + __ffs(real) - 1;
  }
  return hi;
}

// x = big + small: big is x cut to TF32 (its low 13 bits cleared: one
// integer op, where a conversion would take the slower pipe), small =
// x - big exactly in f32, of which the tensor core reads the TF32 part
// (what it drops is under 2^-20 of x).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two 16x8 B fragments (columns n, n + 8) of a row-major (k, n) bf16 slab.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* b0, uint32_t* b1,
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(hopper::smem_u32(p)));
}

// One stage's products: acc (warp's MF x NF fragments) += A[wm0:, 0:KC] @
// B[0:KC, wn0:]. Rows, columns and K past the data are zeros in shared
// memory. The tensor core adds into its accumulator with truncation, whose
// error grows with the accumulator's size and the number of products: the
// stage's products go into a fresh accumulator `part`, which is added to
// acc with rounding (a stage holds 12 products of each fragment).
template <int BN>
__device__ __forceinline__ void compute(const float* As, const float* Bs,
                                        float (*acc)[Tile<float, BN>::NF][4],
                                        int wm0, int wn0, int lane) {
  using L = Tile<float, BN>;
  const int g = lane / 4, t = lane % 4;
  float part[L::MF][L::NF][4];
#pragma unroll
  for (int mf = 0; mf < L::MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < L::NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mf][nf][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < KC; k0 += 8) {
    uint32_t bb[L::NF][2], bs[L::NF][2];
#pragma unroll
    for (int nf = 0; nf < L::NF; ++nf) {
      const float* pb = Bs + (k0 + t) * L::LDB + wn0 + nf * 8 + g;
      split(pb[0], bb[nf][0], bs[nf][0]);
      split(pb[4 * L::LDB], bb[nf][1], bs[nf][1]);
    }
#pragma unroll
    for (int mf = 0; mf < L::MF; ++mf) {
      const float* pa = As + (wm0 + mf * 16 + g) * L::LDA + k0 + t;
      uint32_t ab[4], as[4];
      split(pa[0], ab[0], as[0]);
      split(pa[8 * L::LDA], ab[1], as[1]);
      split(pa[4], ab[2], as[2]);
      split(pa[8 * L::LDA + 4], ab[3], as[3]);
      // the small terms first; each pass runs NF independent products
#pragma unroll
      for (int nf = 0; nf < L::NF; ++nf) mma_tf32(part[mf][nf], as, bb[nf]);
#pragma unroll
      for (int nf = 0; nf < L::NF; ++nf) mma_tf32(part[mf][nf], ab, bs[nf]);
#pragma unroll
      for (int nf = 0; nf < L::NF; ++nf) mma_tf32(part[mf][nf], ab, bb[nf]);
    }
  }
#pragma unroll
  for (int mf = 0; mf < L::MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < L::NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] += part[mf][nf][e];
}

template <int BN>
__device__ __forceinline__ void compute(const bf16* As, const bf16* Bs,
                                        float (*acc)[Tile<bf16, BN>::NF][4],
                                        int wm0, int wn0, int lane) {
  using L = Tile<bf16, BN>;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < KC; k0 += 16) {
    uint32_t b[L::NF][2];
#pragma unroll
    for (int nf = 0; nf < L::NF; nf += 2)
      ldmatrix_x4_trans(b[nf], b[nf + 1],
                        Bs + (k0 + lane % 16) * L::LDB + wn0 + nf * 8 +
                            8 * (lane / 16));
#pragma unroll
    for (int mf = 0; mf < L::MF; ++mf) {
      const bf16* pa = As + (wm0 + mf * 16 + g) * L::LDA + k0 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(pa);
      a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * L::LDA);
      a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * L::LDA + 8);
#pragma unroll
      for (int nf = 0; nf < L::NF; ++nf) mma_bf16(acc[mf][nf], a, b[nf]);
    }
  }
}

// VB: the slab's column tile is copied 16 bytes at a time (d and bd are
// multiples of VEC and h is 16-byte aligned); else one element at a time.
template <typename T, int BN, bool VB>
__global__ void __launch_bounds__(THREADS, (Tile<T, BN>::CTAS)) spmm_tc(Args P) {
  using L = Tile<T, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32, warp = tid / 32;
  const int wm0 = (warp / L::WN) * (BM / L::WM);
  const int wn0 = (warp % L::WN) * (BN / L::WN);

  // blockIdx.x -> (row block r, chunk, column tile ct), ct fastest.
  const int per_bd = (P.bd + BN - 1) / BN;
  const int n_ct = (P.d / P.bd) * per_bd;
  const int ct = static_cast<int>(blockIdx.x % n_ct);
  const int rc = static_cast<int>(blockIdx.x / n_ct);
  const int chunk = rc % P.chunks, r = rc / P.chunks;
  const int jt = ct / per_bd;
  const int c0 = jt * P.bd + (ct % per_bd) * BN;
  const int width = min(BN, (jt + 1) * P.bd - c0);

  const int lo = P.row_ptr[r];
  const long long len = P.row_ptr[r + 1] - lo;
  const int hi = lo + static_cast<int>(len * (chunk + 1) / P.chunks);
  int s = lo + static_cast<int>(len * chunk / P.chunks);

  // Rows bm..BM of every stage's A slice are never copied: zero them once
  // (a row is a whole number of 4-byte words).
  constexpr int ROW_WORDS = L::LDA * static_cast<int>(sizeof(T)) / 4;
  for (int st = 0; st < L::STAGES; ++st) {
    uint32_t* a = reinterpret_cast<uint32_t*>(ring + st * L::STAGE_ELEMS);
    for (int i = P.bm * ROW_WORDS + tid; i < BM * ROW_WORDS; i += THREADS)
      a[i] = 0u;
  }

  const T* blocks = static_cast<const T*>(P.blocks);
  const T* h = static_cast<const T*>(P.h);
  const int n_k = (P.bk + KC - 1) / KC;
  int kci = 0;  // the next K slice of entry s
  s = next_entry(P.sel, s, hi, P.sentinel);

  // Copy entry s's K slice kci into `stage`, then step to the next slice.
  auto copy_in = [&](int stage) {
    T* As = ring + stage * L::STAGE_ELEMS;
    T* Bs = As + L::A_ELEMS;
    const int k0 = kci * KC, kc = min(KC, P.bk - k0);
    const T* tile =
        blocks + (size_t)__ldg(P.sel + s) * P.bm * P.bk + k0;
    constexpr int NVA = KC / L::VEC;
    for (int i = tid; i < P.bm * NVA; i += THREADS) {
      const int row = i / NVA, kk = (i % NVA) * L::VEC;
      const bool ok = kk < kc;
      cp16(As + row * L::LDA + kk, ok ? tile + (size_t)row * P.bk + kk : tile,
           ok);
    }
    const T* slab =
        h + ((size_t)__ldg(P.col_ids + s) * P.bk + k0) * P.d + c0;
    if constexpr (VB) {
      constexpr int NVB = BN / L::VEC;
      for (int i = tid; i < KC * NVB; i += THREADS) {
        const int kk = i / NVB, col = (i % NVB) * L::VEC;
        const bool ok = kk < kc && col < width;
        cp16(Bs + kk * L::LDB + col, ok ? slab + (size_t)kk * P.d + col : slab,
             ok);
      }
    } else {
      for (int i = tid; i < KC * BN; i += THREADS) {
        const int kk = i / BN, col = i % BN;
        const bool ok = kk < kc && col < width;
        cp_elem(Bs + kk * L::LDB + col, ok ? slab + (size_t)kk * P.d + col
                                           : slab, ok);
      }
    }
    if (++kci == n_k) {
      kci = 0;
      s = next_entry(P.sel, s + 1, hi, P.sentinel);
    }
  };

  float acc[L::MF][L::NF][4];
#pragma unroll
  for (int mf = 0; mf < L::MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < L::NF; ++nf)
      acc[mf][nf][0] = acc[mf][nf][1] = acc[mf][nf][2] = acc[mf][nf][3] = 0.f;

  // One commit group per stage; the group of item `it` is complete once at
  // most STAGES - 2 younger groups are pending.
  int queued = 0;
#pragma unroll
  for (int st = 0; st < L::STAGES - 1; ++st) {
    if (s < hi) {
      copy_in(st);
      ++queued;
    }
    cp_commit();
  }
  const bool active = wm0 < P.bm;  // warps wholly below bm rows idle
  for (int it = 0; it < queued; ++it) {
    cp_wait<L::STAGES - 2>();
    __syncthreads();  // item it has landed; item it - 1's stage is free
    if (s < hi) {
      copy_in((it + L::STAGES - 1) % L::STAGES);
      ++queued;
    }
    cp_commit();
    const T* As = ring + (it % L::STAGES) * L::STAGE_ELEMS;
    if (active) compute<BN>(As, As + L::A_ELEMS, acc, wm0, wn0, lane);
  }

  const int g = lane / 4, t = lane % 4;
  const size_t n_out = (size_t)P.n_row_blocks * P.bm;
#pragma unroll
  for (int mf = 0; mf < L::MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < L::NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm0 + mf * 16 + g + 8 * (e / 2);
        const int col = wn0 + nf * 8 + 2 * t + e % 2;
        if (row >= P.bm || col >= width) continue;
        const size_t i = ((size_t)r * P.bm + row) * P.d + c0 + col;
        if (P.chunks == 1)
          finish<T>(P, i, c0 + col, acc[mf][nf][e]);
        else
          P.ws[(size_t)chunk * n_out * P.d + i] = acc[mf][nf][e];
      }
}

// out = epi(sum of the chunks' partials, in chunk order).
template <typename T>
__global__ void __launch_bounds__(THREADS) reduce_chunks(Args P) {
  const size_t n = (size_t)P.n_row_blocks * P.bm * P.d;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float y = 0.f;
    for (int j = 0; j < P.chunks; ++j) y += P.ws[j * n + i];
    finish<T>(P, i, static_cast<int>(i % P.d), y);
  }
}

template <typename T, int BN, bool VB>
cudaError_t launch(const Args& P, cudaStream_t st) {
  const long long ctas = (long long)P.n_row_blocks * P.chunks *
                         (P.d / P.bd) * ((P.bd + BN - 1) / BN);
  cudaError_t err =
      hopper::launch(spmm_tc<T, BN, VB>, dim3(static_cast<unsigned>(ctas)),
                     THREADS, Tile<T, BN>::SMEM, st, P);
  if (err != cudaSuccess || P.chunks == 1) return err;
  const size_t n = (size_t)P.n_row_blocks * P.bm * P.d;
  const size_t grid = (n + THREADS - 1) / THREADS;
  reduce_chunks<T><<<static_cast<unsigned>(grid < 2048 ? grid : 2048),
                     THREADS, 0, st>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& P, cudaStream_t st) {
  constexpr int VEC = Tile<T, 64>::VEC;
  const bool vb = P.d % VEC == 0 && P.bd % VEC == 0 &&
                  reinterpret_cast<uintptr_t>(P.h) % 16 == 0;
  if (P.bd <= 48)
    return vb ? launch<T, 48, true>(P, st) : launch<T, 48, false>(P, st);
  if (P.bd <= 64)
    return vb ? launch<T, 64, true>(P, st) : launch<T, 64, false>(P, st);
  return vb ? launch<T, 128, true>(P, st) : launch<T, 128, false>(P, st);
}

}  // namespace tc

// ----------------------------------------------------- fma (FP32 FMAs)

namespace simt {

constexpr int BM_MAX = 128;   // rows of an output tile (bm <= BM_MAX)
constexpr int TD = 64;        // columns of an output tile
constexpr int KC = 32;        // depth of one staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TR = BM_MAX / 16;  // rows per thread
constexpr int TC = TD / 16;      // columns per thread

// One CTA per output tile of bm rows by at most TD columns: grid
// (n_row_blocks, d / bd, ceil(bd / TD)). It walks its segment, stages
// KC-deep chunks of the tile and of the slab in shared memory and
// accumulates in registers (8 x 4 per thread).
template <typename T>
__global__ void __launch_bounds__(THREADS) spmm_fma(Args P) {
  __shared__ float As[BM_MAX][KC + 1];  // +1: no bank conflicts on stores
  __shared__ float Bs[KC][TD];

  const T* blocks = static_cast<const T*>(P.blocks);
  const T* h = static_cast<const T*>(P.h);
  const int bm = P.bm, bk = P.bk, d = P.d;
  const int r = static_cast<int>(blockIdx.x);
  const int jt = static_cast<int>(blockIdx.y);  // bd-wide column tile
  const int tid = static_cast<int>(threadIdx.x);
  const int c0 = jt * P.bd + static_cast<int>(blockIdx.z) * TD;
  const int c1 = min(c0 + TD, (jt + 1) * P.bd);
  const int tx = tid % 16;
  const int ty = tid / 16;

  // Rows bm..BM_MAX of As are never loaded: zero them once so the unused
  // accumulators read defined values.
  for (int i = bm * (KC + 1) + tid; i < BM_MAX * (KC + 1); i += THREADS) {
    (&As[0][0])[i] = 0.f;
  }

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  }

  const int lo = P.row_ptr[r];
  const int hi = P.row_ptr[r + 1];
  const size_t tile_elems = (size_t)bm * bk;
  for (int s = lo; s < hi; ++s) {
    const int t = P.sel[s];
    if (t == P.sentinel) continue;  // uniform across the CTA
    const T* tile = blocks + (size_t)t * tile_elems;
    const T* slab = h + (size_t)P.col_ids[s] * bk * d;
    for (int k0 = 0; k0 < bk; k0 += KC) {
      const int kc = min(KC, bk - k0);
      __syncthreads();  // the previous chunk has been consumed
      for (int i = tid; i < bm * KC; i += THREADS) {
        const int row = i / KC, kk = i % KC;
        As[row][kk] =
            kk < kc ? to_f32(tile[(size_t)row * bk + k0 + kk]) : 0.f;
      }
      for (int i = tid; i < KC * TD; i += THREADS) {
        const int kk = i / TD, c = i % TD;
        const int col = c0 + c;
        Bs[kk][c] = (kk < kc && col < c1)
                        ? to_f32(slab[(size_t)(k0 + kk) * d + col])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        float a[TR], b[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < TC; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = ty + 16 * i;
    if (row >= bm) continue;
    const size_t base = ((size_t)r * bm + row) * d;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= c1) continue;
      finish<T>(P, base + col, col, acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const Args& P, cudaStream_t st) {
  const dim3 grid(P.n_row_blocks, P.d / P.bd, (P.bd + TD - 1) / TD);
  spmm_fma<T><<<grid, THREADS, 0, st>>>(P);
  return cudaGetLastError();
}

}  // namespace simt

enum Variant { FMA = 0, TF32X3 = 1, MMA = 2 };  // the wrapper's VARIANTS

}  // namespace

// Launches `variant` on `stream` and returns the CUDA error (0 on success).
// Pointers are device pointers; bias and residual may be null, and ws is
// an f32 (chunks, n_row_blocks * bm, d) workspace when chunks > 1. The
// caller has checked shapes, dtypes and index ranges, that bd divides d,
// that the variant takes them (fma: f32 or bf16, chunks == 1; tf32x3: f32;
// mma: bf16; both with bk % 8 == 0 and blocks and h 16-byte aligned) and
// that the grid fits.
extern "C" int bcoo_spmm_launch(const void* blocks, const void* sel,
                                const void* col_ids, const void* row_ptr,
                                const void* h, const void* bias,
                                const void* residual, void* out, void* ws,
                                int n_row_blocks, int bm, int bk, int d,
                                int bd, int sentinel, int relu, int is_bf16,
                                int variant, int chunks, void* stream) {
  const Args P{blocks,
               static_cast<const int*>(sel),
               static_cast<const int*>(col_ids),
               static_cast<const int*>(row_ptr),
               h,
               bias,
               residual,
               out,
               static_cast<float*>(ws),
               n_row_blocks,
               bm,
               bk,
               d,
               bd,
               sentinel,
               relu,
               chunks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunks < 1 || (chunks > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case TF32X3:
      if (is_bf16 || bk % 8) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(tc::dispatch<float>(P, st));
    case MMA:
      if (!is_bf16 || bk % 8) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(tc::dispatch<bf16>(P, st));
    case FMA:
      if (chunks != 1) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(is_bf16 ? simt::launch<bf16>(P, st)
                                      : simt::launch<float>(P, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
