// Row-segmented block-COO SpMM with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bcoo_spmm.py:bcoo_spmm
// (its pallas_call is at line 164). It computes the same function:
//
//   out[r*bm:(r+1)*bm, c] = epi( sum_{s in [row_ptr[r], row_ptr[r+1])}
//                                blocks[sel[s]] @ h[col_ids[s]*bk:+bk, c] )
//   epi(y) = relu?( y + bias[c] + residual[r*bm:(r+1)*bm, c] )
//
// with f32 accumulation, inputs in f32 or bf16, the output in h's dtype,
// and every output tile written exactly once (no atomics, so the result is
// deterministic). An empty segment yields epi(0). Entries whose sel equals
// `sentinel` (the all-zero padding tile) are skipped: they add nothing,
// and a partition's padding piles up at its last row block, where walking
// them would serialise one CTA behind thousands of zero tiles.
//
// What bounds it on an H100 SXM (TF32 is off, so products run on the FP32
// pipes at 67 TFLOP/s; memory 3.35 TB/s): per active tile it reads the
// (bm, bk) tile and a (bk, d) slab of h, n_active*(bm*bk + bk*d)*4 bytes,
// against 2*n_active*bm*bk*d FLOP. At bm=bk=128 that is 42.7 FLOP/B for
// d=256 (above the card's 20 FLOP/B balance: operations bound) and 15.5
// FLOP/B for d=41 (bytes bound).
//
// Design. The TPU kernel walks one output tile per grid step with
// double-buffered DMA into a VMEM accumulator. Here one CTA owns one
// output tile of bm rows by at most TD columns: grid (n_row_blocks,
// d/bd, ceil(bd/TD)), so the dispatcher's column tile bd is cut further
// into register-sized pieces. The CTA loads its own row_ptr[r],
// row_ptr[r+1] and walks the segment; per tile it stages KC-deep chunks of
// the tile and of the slab in shared memory (25 KB static, under the
// 48 KB static limit for any bk) and accumulates bm x TD partial sums in
// f32 registers (8 x 4 per thread). After the walk it applies the epilogue
// and stores. This is the simple correct version: no tensor cores, no
// TMA/cp.async pipeline and no split of heavy row blocks yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM_MAX = 128;   // rows of an output tile (bm <= BM_MAX)
constexpr int TD = 64;        // columns of an output tile
constexpr int KC = 32;        // depth of one staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TR = BM_MAX / 16;  // rows per thread
constexpr int TC = TD / 16;      // columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) bcoo_spmm_kernel(
    const T* __restrict__ blocks, const int* __restrict__ sel,
    const int* __restrict__ col_ids, const int* __restrict__ row_ptr,
    const T* __restrict__ h, const T* __restrict__ bias,
    const T* __restrict__ residual, T* __restrict__ out, int bm, int bk,
    int d, int bd, int sentinel, int relu) {
  __shared__ float As[BM_MAX][KC + 1];  // +1: no bank conflicts on stores
  __shared__ float Bs[KC][TD];

  const int r = static_cast<int>(blockIdx.x);
  const int jt = static_cast<int>(blockIdx.y);  // bd-wide column tile
  const int tid = static_cast<int>(threadIdx.x);
  const int c0 = jt * bd + static_cast<int>(blockIdx.z) * TD;
  const int c1 = min(c0 + TD, (jt + 1) * bd);
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

  const int lo = row_ptr[r];
  const int hi = row_ptr[r + 1];
  const size_t tile_elems = (size_t)bm * bk;
  for (int s = lo; s < hi; ++s) {
    const int t = sel[s];
    if (t == sentinel) continue;  // uniform across the CTA
    const T* tile = blocks + (size_t)t * tile_elems;
    const T* slab = h + (size_t)col_ids[s] * bk * d;
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
      float y = acc[i][j];
      if (bias != nullptr) y += to_f32(bias[col]);
      if (residual != nullptr) y += to_f32(residual[base + col]);
      if (relu) y = y < 0.f ? 0.f : y;  // NaN passes through, as in torch
      store(out + base + col, y);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; bias and residual may be null. The caller
// has checked shapes, dtypes and index ranges, and that bd divides d.
extern "C" int bcoo_spmm_launch(const void* blocks, const void* sel,
                                const void* col_ids, const void* row_ptr,
                                const void* h, const void* bias,
                                const void* residual, void* out,
                                int n_row_blocks, int bm, int bk, int d,
                                int bd, int sentinel, int relu, int is_bf16,
                                void* stream) {
  const dim3 grid(n_row_blocks, d / bd, (bd + TD - 1) / TD);
  const dim3 block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sel_i = static_cast<const int*>(sel);
  const int* col_i = static_cast<const int*>(col_ids);
  const int* ptr_i = static_cast<const int*>(row_ptr);
  if (is_bf16) {
    using T = __nv_bfloat16;
    bcoo_spmm_kernel<T><<<grid, block, 0, st>>>(
        static_cast<const T*>(blocks), sel_i, col_i, ptr_i,
        static_cast<const T*>(h), static_cast<const T*>(bias),
        static_cast<const T*>(residual), static_cast<T*>(out), bm, bk, d, bd,
        sentinel, relu);
  } else {
    bcoo_spmm_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(blocks), sel_i, col_i, ptr_i,
        static_cast<const float*>(h), static_cast<const float*>(bias),
        static_cast<const float*>(residual), static_cast<float*>(out), bm, bk,
        d, bd, sentinel, relu);
  }
  return static_cast<int>(cudaGetLastError());
}
