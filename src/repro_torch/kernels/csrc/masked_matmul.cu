// Block-sparse masked matrix products for Helios soft-training, by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/masked_matmul.py:
//   helios_masked_matmul    <- masked_matmul    (_call with alive_axis="n"):
//       y = x @ w where every output-column block the mask killed is zero
//       and its weights are never read (masked_dense forward and dw).
//   helios_masked_matmul_dk <- masked_matmul_dk (_call with alive_axis="k"):
//       y = x @ w with the dead contraction blocks skipped, exact because
//       their operand entries are zero (masked_dense dx).
//
// What bounds it on the card: at the main-path shapes (a batch of M = 32
// rows against AlexNet's fc0 and fc1 weights, K and N in the thousands)
// each f32 weight is used for M = 32 multiply-adds, about 16 FLOP per byte,
// below the H100's ~20 f32 FLOP per byte of memory traffic (67 TFLOP/s over
// 3.35 TB/s).  The kernels are bound by the bytes of the live weight blocks.
//
// What the design does about it: a block the Helios mask killed is never
// read.  The wrapper compacts the live mask blocks into a list of indices;
// helios_masked_matmul launches thread blocks for live output tiles only,
// and helios_masked_matmul_dk walks only the live contraction blocks in its
// K loop.  Dead output columns keep the zeros the wrapper allocated.  The
// mask block (128 on the main path) is a launch argument apart from the
// tile width: a 64-column tile reads the index of the mask block it lies in
// and never crosses into the next one.  Operands may be row- or
// column-major views (the backward pass hands over transposes without
// copying) and each tile load picks the thread order that keeps global
// reads coalesced.  Ragged M/N/K edges are masked in the loads and stores.
// The product is IEEE f32 FMA with an f32 accumulator (no TF32); bf16
// inputs are widened on load and the result is rounded once on store.
// This is the simple first version: one 32-deep stage at a time, no
// split-K, no wgmma or TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;        // output rows per tile
constexpr int BN = 64;        // output columns per tile
constexpr int BK = 32;        // contraction depth per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16; each thread owns 2 rows x 4 columns

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Operands {
  const void* x;       // (m, k), element strides sxm, sxk
  const void* w;       // (k, n), element strides swk, swn
  void* y;             // (m, n), row-major, contiguous, zero-filled
  const int* live;     // indices of the live mask blocks, ascending
  long long m, n, k;
  long long sxm, sxk, swk, swn;
  int n_live;          // length of `live`
  int block;           // mask block width (columns, or contraction rows)
};

// SKIP_K = false: the tile's columns come from the live list (grid.y walks
// live tiles only).  SKIP_K = true: grid.y walks every column tile and the
// K loop walks the live contraction blocks only.
template <typename T, bool SKIP_K>
__global__ void __launch_bounds__(THREADS) masked_mm_kernel(Operands op) {
  __shared__ float xs[BK][BM + 1];   // +1: column-major stores hit distinct banks
  __shared__ float ws[BK][BN + 1];
  const T* __restrict__ x = static_cast<const T*>(op.x);
  const T* __restrict__ w = static_cast<const T*>(op.w);
  T* __restrict__ y = static_cast<T*>(op.y);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;

  long long n0, n1;
  if (SKIP_K) {
    n0 = static_cast<long long>(blockIdx.y) * BN;
    n1 = min(n0 + BN, op.n);
  } else {
    const int tiles = (op.block + BN - 1) / BN;   // tiles per mask block
    const long long b0 = static_cast<long long>(op.live[blockIdx.y / tiles]) * op.block;
    n0 = b0 + static_cast<long long>(blockIdx.y % tiles) * BN;
    n1 = min(min(n0 + BN, b0 + op.block), op.n);
    if (n0 >= n1) return;   // past a ragged last block; uniform over the block
  }
  const bool x_rows = op.sxk == 1;   // x row-major: neighbouring threads walk k
  const bool w_rows = op.swn == 1;   // w row-major: neighbouring threads walk n

  float acc[2][4] = {};
  const int segments = SKIP_K ? op.n_live : 1;
  for (int s = 0; s < segments; ++s) {
    long long k_lo = 0, k_hi = op.k;
    if (SKIP_K) {
      k_lo = static_cast<long long>(op.live[s]) * op.block;
      k_hi = min(k_lo + op.block, op.k);
    }
    for (long long k0 = k_lo; k0 < k_hi; k0 += BK) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = x_rows ? i / BK : i % BM;
        const int c = x_rows ? i % BK : i / BM;
        const long long gm = m0 + r, gk = k0 + c;
        xs[c][r] = (gm < op.m && gk < k_hi) ? widen(x[gm * op.sxm + gk * op.sxk]) : 0.f;
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int r = w_rows ? i / BN : i % BK;
        const int c = w_rows ? i % BN : i / BK;
        const long long gk = k0 + r, gn = n0 + c;
        ws[r][c] = (gk < k_hi && gn < n1) ? widen(w[gk * op.swk + gn * op.swn]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float a0 = xs[kk][ty], a1 = xs[kk][ty + 16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = ws[kk][tx + 16 * j];
          acc[0][j] = fmaf(a0, b, acc[0][j]);
          acc[1][j] = fmaf(a1, b, acc[1][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long gm = m0 + ty + 16 * i;
    if (gm >= op.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gn = n0 + tx + 16 * j;
      if (gn < n1) store(&y[gm * op.n + gn], acc[i][j]);
    }
  }
}

template <bool SKIP_K>
int launch(int dtype, const Operands& op, cudaStream_t stream) {
  const long long tiles_m = (op.m + BM - 1) / BM;
  long long tiles_n;
  if (SKIP_K) {
    tiles_n = (op.n + BN - 1) / BN;
  } else {
    tiles_n = static_cast<long long>(op.n_live) * ((op.block + BN - 1) / BN);
  }
  if (tiles_m <= 0 || tiles_n <= 0 || tiles_m > 2147483647LL || tiles_n > 65535LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(tiles_m), static_cast<unsigned>(tiles_n));
  if (dtype == 0) {
    masked_mm_kernel<float, SKIP_K><<<grid, THREADS, 0, stream>>>(op);
  } else if (dtype == 1) {
    masked_mm_kernel<__nv_bfloat16, SKIP_K><<<grid, THREADS, 0, stream>>>(op);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

Operands pack(const void* x, const void* w, void* y, const int* live, int n_live,
              int block, long long m, long long n, long long k, long long sxm,
              long long sxk, long long swk, long long swn) {
  Operands op;
  op.x = x; op.w = w; op.y = y; op.live = live;
  op.m = m; op.n = n; op.k = k;
  op.sxm = sxm; op.sxk = sxk; op.swk = swk; op.swn = swn;
  op.n_live = n_live; op.block = block;
  return op;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int helios_masked_matmul(int dtype, const void* x, const void* w, void* y,
                                    const int* live, int n_live, int block_n,
                                    long long m, long long n, long long k,
                                    long long sxm, long long sxk, long long swk,
                                    long long swn, void* stream) {
  return launch<false>(dtype, pack(x, w, y, live, n_live, block_n, m, n, k, sxm, sxk, swk, swn),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int helios_masked_matmul_dk(int dtype, const void* x, const void* w, void* y,
                                       const int* live, int n_live, int block_k,
                                       long long m, long long n, long long k,
                                       long long sxm, long long sxk, long long swk,
                                       long long swn, void* stream) {
  return launch<true>(dtype, pack(x, w, y, live, n_live, block_k, m, n, k, sxm, sxk, swk, swn),
                      static_cast<cudaStream_t>(stream));
}
