// Causal or full online-softmax attention (the forward pass), by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py:70 (body _kernel, :23):
//   o = softmax(q kᵀ · hd^-0.5, masked) v   over (B, H, S, hd) operands,
// with masked scores at -1e30, f32 running max / denominator / accumulator,
// the denominator clamped at 1e-30 before the divide, and the output in q's
// dtype.  Under the causal mask the key tiles above the diagonal are never
// visited.  There is no backward kernel: as in the reference, the gradient
// recomputes the dense attention under autograd.
//
// What bounds it on the card: at the LM slice's shape (B, H, S, hd) =
// (4, 32, 512, 128), causal, f32, the two products per tile are 2·S²·hd
// FLOP per head after the causal half, 8.6 GFLOP over 128 heads: 0.128 ms at
// the H100's 67 TFLOP/s of f32 FMA on the CUDA cores (no TF32, for parity
// with the reference).  q, k, v and o are 33.5 MB each, 134 MB in all, or
// 0.040 ms at 3.35 TB/s.  So the kernel is bound by operations; each K/V
// tile is reused by a whole query tile (64 rows), about 16 FLOP per byte
// loaded from device memory.
//
// What the design does about it: one thread block of 256 threads per
// (batch·head, 64-row query tile).  The query tile stays in shared memory
// for the whole key loop; each 64-row K and V tile is staged once in shared
// memory and used by all 64 query rows, so device memory is read once per
// query tile and the scores never leave the chip.  Each thread owns a 4x4
// block of the 64x64 score tile and a 4 x hd/16 block of the output
// accumulator (the same 4 rows), so the running max and denominator of a
// row live in the registers of the 16 lanes that share it and are reduced
// with warp shuffles; only the probabilities pass through shared memory on
// their way to the P·V product.  Rows are padded by one float so the
// column walks of Q·Kᵀ hit distinct banks.  The causal key loop stops at
// the diagonal tile and masks inside it; ragged keys are masked to -1e30
// and ragged query rows are not stored, so no operand is padded.  The
// kernel takes element strides for B, H and S (the head dim is unit
// stride), so the transposed (B, S, H, hd) views the model hands over are
// read in place, and the output is written in the layout the caller
// allocated.  bf16 inputs are widened on load and rounded once on store.
// This is the simple first version: IEEE f32 FMA on the CUDA cores, no
// TF32, no wgmma, no TMA, no pipelining of the next tile's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per thread block
constexpr int BKV = 64;        // key / value rows per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16; each thread owns 4 rows
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Operands {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads;
  long long sq, sk;
  long long qsb, qsh, qss;     // element strides of q over B, H, S
  long long ksb, ksh, kss;
  long long vsb, vsh, vss;
  long long osb, osh, oss;
  float scale;
  int causal;
};

// reduce over the 16 lanes that share one row (lanes differ in bits 0-3);
// a butterfly leaves the same bits in every lane
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Operands op) {
  constexpr int QP = HD + 1;           // padded row pitch of Q and K tiles
  constexpr int PP = BKV + 1;          // padded row pitch of the P tile
  constexpr int CJ = HD / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][QP]
  float* ks = qs + BQ * QP;            // [BKV][QP]
  float* vs = ks + BKV * QP;           // [BKV][HD]
  float* ps = vs + BKV * HD;           // [BQ][PP]

  const T* __restrict__ q = static_cast<const T*>(op.q);
  const T* __restrict__ k = static_cast<const T*>(op.k);
  const T* __restrict__ v = static_cast<const T*>(op.v);
  T* __restrict__ o = static_cast<T*>(op.o);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long b = blockIdx.x / op.heads, h = blockIdx.x % op.heads;
  const long long q0 = static_cast<long long>(blockIdx.y) * BQ;
  q += b * op.qsb + h * op.qsh;
  k += b * op.ksb + h * op.ksh;
  v += b * op.vsb + h * op.vsh;
  o += b * op.osb + h * op.osh;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const long long gq = q0 + r;
    qs[r * QP + c] = gq < op.sq ? widen(q[gq * op.qss + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  // causal: the last key any row of this tile may see is min(q0+BQ, sk)-1
  const long long kv_end = op.causal ? min(q0 + BQ, op.sk) : op.sk;
  for (long long k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();                   // the last tile's readers are done
    for (int i = tid; i < BKV * HD; i += THREADS) {
      const int r = i / HD, c = i % HD;
      const long long gk = k0 + r;
      const bool in = gk < op.sk;
      ks[r * QP + c] = in ? widen(k[gk * op.kss + c]) : 0.f;
      vs[r * HD + c] = in ? widen(v[gk * op.vss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long gq = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long gk = k0 + tx + 16 * j;
        float x = s[i][j] * op.scale;
        if (gk >= op.sk || (op.causal && gk > gq)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float vb = vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vb, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gq = q0 + ty + 16 * i;
    if (gq >= op.sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CJ; ++j) store(&o[gq * op.oss + tx + 16 * j], acc[i][j] * inv);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1));
}

template <typename T, int HD>
int launch_typed(const Operands& op, long long batch_heads, cudaStream_t stream) {
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long q_tiles = (op.sq + BQ - 1) / BQ;
  if (batch_heads <= 0 || q_tiles <= 0 || batch_heads > 2147483647LL || q_tiles > 65535LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(batch_heads), static_cast<unsigned>(q_tiles));
  flash_fwd_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int hd, const Operands& op, long long batch_heads, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_typed<T, 16>(op, batch_heads, stream);
    case 64: return launch_typed<T, 64>(op, batch_heads, stream);
    case 128: return launch_typed<T, 128>(op, batch_heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 64, 128}.  Strides are in
// elements, the head dim is unit stride.  Returns a cudaError_t (0 = launched).
extern "C" int helios_flash_attention(int dtype, int hd, const void* q, const void* k,
                                      const void* v, void* o, long long batch, int heads,
                                      long long sq, long long sk, int causal, float scale,
                                      long long qsb, long long qsh, long long qss,
                                      long long ksb, long long ksh, long long kss,
                                      long long vsb, long long vsh, long long vss,
                                      long long osb, long long osh, long long oss,
                                      void* stream) {
  Operands op;
  op.q = q; op.k = k; op.v = v; op.o = o;
  op.heads = heads; op.sq = sq; op.sk = sk;
  op.qsb = qsb; op.qsh = qsh; op.qss = qss;
  op.ksb = ksb; op.ksh = ksh; op.kss = kss;
  op.vsb = vsb; op.vsh = vsh; op.vss = vss;
  op.osb = osb; op.osh = osh; op.oss = oss;
  op.scale = scale; op.causal = causal;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bh = batch * heads;
  if (dtype == 0) return launch<float>(hd, op, bh, s);
  if (dtype == 1) return launch<__nv_bfloat16>(hd, op, bh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
