// Causal or full online-softmax attention (the forward pass), by hand for
// Hopper (sm_90a), on the tensor cores with a 3xTF32 split product.
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
// (4, 32, 512, 128), causal, f32, the two products are 4·hd FLOP per kept
// (query, key) pair, 8.607 GFLOP in all.  q, k, v and o are 33.5 MB each,
// 134 MB, or 0.040 ms at 3.35 TB/s.  On the CUDA cores (67 TFLOP/s of f32
// FMA) the operations take 0.128 ms.  Here every product is three TF32
// products (below), 25.8 GFLOP at the 495 TFLOP/s of dense TF32: 0.052 ms.
// Either way the kernel is bound by operations.
//
// Why three products: one TF32 product keeps 10 mantissa bits of each
// operand and misses the port's 1e-4 parity gate (about 5e-4 relative at
// the slice shape).  Each operand x is split into hi = rna_tf32(x) and
// lo = x - hi, which the MMA reads cut to TF32; hi + lo holds x to 2^-21,
// and hi·lo + lo·hi + hi·hi, summed in f32 (the two small products first,
// as CUTLASS's 3xTF32 does), lands within about 2e-7 of the f64 product
// (tests/test_torch_tf32x3.py emulates it).  Leaving lo to the MMA's cut
// instead of a second cvt.rna saves an instruction per operand and
// measured no less accurate.  A bf16 operand takes the same path: its hi
// is exact and its lo is 0.
//
// What the design does:
// - one block of four warps per (batch·head, 64-row query tile); each warp
//   owns 16 query rows.  S = Q·Kᵀ and O += P·V run as
//   mma.sync.m16n8k8.tf32 with f32 accumulators, three per split product,
//   issued as three passes over independent accumulators;
// - the online softmax works on the accumulators in the MMA's C layout: a
//   thread holds rows g and g+8, keys 2t and 2t+1 of each 8-key tile, so a
//   row's max is reduced over the 4 lanes of a quad (two shuffles) and its
//   denominator is summed per thread and reduced once at the end;
// - P stays in registers.  The A operand of P·V wants contraction slots t
//   and t+4 where the C fragment holds keys 2t and 2t+1; the key index is
//   summed over, so slot t takes key 2t and slot t+4 key 2t+1, and V's B
//   fragment is read from the same two key rows.  No shuffle, no P tile;
// - Q stays in shared memory; K and V stream in 16-key stages, double-
//   buffered with 16-byte cp.async (commit / wait_group), the next stage
//   in flight during this one's products.  At hd = 128, f32 that is
//   Q 33 KB + 2 × (K, V) 33 KB = 66 KB, so three blocks share an SM: the
//   instruction stream of one warp cannot hide the MMA and shared-memory
//   latencies alone (64-key stages need 165 KB, one block an SM, and are
//   several times slower).  Rows are padded by 16 bytes, so every fragment
//   read is free of bank conflicts (row pitch ≡ 4 words mod 32); f32 Q and
//   K fragments come from ldmatrix (four 8-row × 4-word matrices each);
// - where a view is not 16-byte aligned (a base pointer, or a B, H or S
//   stride that is not a multiple of 16 bytes) the same kernel copies
//   element by element (4-byte cp.async for f32, plain loads for bf16);
//   the wrapper passes the flag;
// - causal: the key loop stops at the query tile's last row and only the
//   stages that cross the diagonal are masked; in them a warp skips the
//   8-key tiles past its last row.  Ragged keys are masked to -1e30 and
//   ragged query rows are not stored, so no operand is padded.  Strided
//   (B, H, S) views with a unit-stride head dim are read in place and the
//   output is written in the caller's layout.  Query tiles are issued last
//   tile first, so the longest blocks of the causal triangle start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;         // query rows per block, 16 a warp
constexpr int BKV = 16;                // key / value rows per stage
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// x ≈ hi + lo for the 3xTF32 product: hi = x rounded to TF32 (nearest,
// ties away; cvt leaves the low 13 bits zero), lo = x - hi, exact in f32.
// The MMA reads the top 19 bits of each operand, so lo enters it cut to
// TF32: hi + lo holds x to 2^-21 relative, and no second cvt is issued
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 matrices of 16-bit pairs from shared memory; lane i names row
// i % 8 of matrix i / 8 and receives word (i % 4) of row (i / 4) of each.
// On 4-byte elements that is an m16n8k8 TF32 A fragment (rows g, g + 8,
// columns t, t + 4), or the B fragments of two 8-column tiles
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16-byte async copy, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
// one element: a 4-byte async copy (f32) or a plain load and store (bf16)
__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          bool valid) {
  *dst = valid ? *src : __float2bfloat16(0.f);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
  int vec;                     // every q/k/v row 16-byte aligned
};

// row pitch of a shared tile: HD elements and 16 bytes of padding
template <typename T, int HD>
__host__ __device__ constexpr int pitch() { return HD + 16 / static_cast<int>(sizeof(T)); }

// rows [r0, r0 + R) of a (rows, HD) operand with row stride rs into an
// [R][pitch] tile; rows at or past `rows` are zero
template <typename T, int HD, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs, int r0, int rows,
                                          bool vec, int tid) {
  constexpr int P = pitch<T, HD>();
  if (vec) {
    // thread tid copies chunk tid % CPR of rows tid / CPR + RPI·j
    constexpr int PER = 16 / sizeof(T);          // elements per 16-byte chunk
    constexpr int CPR = HD / PER;                // chunks per row
    constexpr int RPI = THREADS / CPR;           // rows per pass
    const int r = tid / CPR, c = (tid % CPR) * PER;
    const T* s = src + static_cast<long long>(r0 + r) * rs + c;
    T* d = dst + r * P + c;
#pragma unroll
    for (int j = 0; j < (R + RPI - 1) / RPI; ++j) {
      if (R % RPI != 0 && r + j * RPI >= R) break;
      const bool ok = r0 + r + j * RPI < rows;
      cp_async16(d + j * RPI * P, ok ? s + j * RPI * rs : src, ok);
    }
  } else {
    for (int i = tid; i < R * HD; i += THREADS) {
      const int r = i / HD, c = i % HD;
      const bool ok = r0 + r < rows;
      copy_elem(dst + r * P + c, ok ? src + static_cast<long long>(r0 + r) * rs + c : src, ok);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 3) flash_fwd_kernel(Operands op) {
  constexpr int P = pitch<T, HD>();
  constexpr int KV = BKV * P;                    // elements of one K or V stage
  constexpr int NT = HD / 8;                     // 8-column tiles of hd
  constexpr int NJ = BKV / 8;                    // 8-key tiles of a stage
  constexpr int NG = NT < 4 ? NT : 4;            // output tiles per MMA batch of P·V
  static_assert(NT % NG == 0, "hd is a whole number of MMA batches");
  static_assert(NJ % 2 == 0, "ldmatrix reads key tiles in pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);        // [BQ][P]
  T* ks = qs + BQ * P;                           // [2][BKV][P]
  T* vs = ks + 2 * KV;                           // [2][BKV][P]

  const T* __restrict__ q = static_cast<const T*>(op.q);
  const T* __restrict__ k = static_cast<const T*>(op.k);
  const T* __restrict__ v = static_cast<const T*>(op.v);
  T* __restrict__ o = static_cast<T*>(op.o);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;          // MMA group and thread in group
  const long long b = blockIdx.x / op.heads, h = blockIdx.x % op.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // 32-bit row coordinates (the launch keeps Sq and Sk below 2^31); only
  // the address products are 64-bit
  const int sq = static_cast<int>(op.sq), sk = static_cast<int>(op.sk);
  q += b * op.qsb + h * op.qsh;
  k += b * op.ksb + h * op.ksh;
  v += b * op.vsb + h * op.vsh;
  o += b * op.osb + h * op.osh;
  const bool vec = op.vec != 0, causal = op.causal != 0;

  // causal: the last key any row of this tile may see is min(q0+BQ, sk)-1
  const int kv_end = causal ? min(q0 + BQ, sk) : sk;
  const int tiles = (kv_end + BKV - 1) / BKV;

  load_tile<T, HD, BQ>(qs, q, op.qss, q0, sq, vec, tid);
  load_tile<T, HD, BKV>(ks, k, op.kss, 0, sk, vec, tid);
  load_tile<T, HD, BKV>(vs, v, op.vss, 0, sk, vec, tid);
  cp_async_commit();

  const int r0 = warp * 16 + g;                  // this thread's rows r0, r0 + 8
  const int gq0 = q0 + r0, gq1 = gq0 + 8;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      const int kn = (it + 1) * BKV;
      load_tile<T, HD, BKV>(ks + (st ^ 1) * KV, k, op.kss, kn, sk, vec, tid);
      load_tile<T, HD, BKV>(vs + (st ^ 1) * KV, v, op.vss, kn, sk, vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + st * KV;
    const T* vt = vs + st * KV;
    const int k0 = it * BKV;
    // causal: this warp sees keys up to q0 + 16w + 15, so the 8-key tiles
    // j > jmax of the stage are all masked (jmax < 0: the whole stage)
    const int last = q0 + warp * 16 + 15 - k0;
    const int jmax = !causal ? NJ - 1 : last < 0 ? -1 : min(NJ - 1, last / 8);

    // S = Q·Kᵀ for this warp's 16 rows and the stage's keys; per k-step
    // the K fragments first, then each of the three products over every
    // key tile, so that NJ independent MMAs are in flight
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      unsigned ah[4], al[4], bh[NJ][2], bl[NJ][2];
      if constexpr (sizeof(T) == 4) {
        // f32 tiles: one ldmatrix for Q's fragment, one per two key tiles
        unsigned r[4];
        ldmatrix_x4(r, qs + (warp * 16 + (lane & 15)) * P + kk * 8 + (lane >> 4) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          ldmatrix_x4(r, kt + ((j + (lane >> 4)) * 8 + (lane & 7)) * P + kk * 8 +
                             ((lane >> 3) & 1) * 4);
          split(__uint_as_float(r[0]), bh[j][0], bl[j][0]);
          split(__uint_as_float(r[1]), bh[j][1], bl[j][1]);
          split(__uint_as_float(r[2]), bh[j + 1][0], bl[j + 1][0]);
          split(__uint_as_float(r[3]), bh[j + 1][1], bl[j + 1][1]);
        }
      } else {
        const int c = kk * 8 + t;
        split(widen(qs[r0 * P + c]), ah[0], al[0]);
        split(widen(qs[(r0 + 8) * P + c]), ah[1], al[1]);
        split(widen(qs[r0 * P + c + 4]), ah[2], al[2]);
        split(widen(qs[(r0 + 8) * P + c + 4]), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j > jmax) continue;
          const T* kr = kt + (j * 8 + g) * P + c;
          split(widen(kr[0]), bh[j][0], bl[j][0]);
          split(widen(kr[4]), bh[j][1], bl[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j <= jmax) mma(s[j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j <= jmax) mma(s[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j <= jmax) mma(s[j], ah, bh[j]);
    }

    // scale, mask, and the online softmax on the C fragments
    const bool masked = (causal && k0 + BKV > q0) || k0 + BKV > sk;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * op.scale;
        if (masked) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? gq0 : gq1;
          if (key >= sk || (causal && key > row)) x = NEG_INF;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e / 2]);
        s[j][e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P·V: P's C fragment as the A operand, slot t = key 2t and
    // slot t + 4 = key 2t + 1 of each 8-key tile; V's fragments NG output
    // tiles at a time, then the three products over those NG tiles
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j > jmax) continue;                    // P is 0 there
      unsigned ah[4], al[4];
      split(s[j][0], ah[0], al[0]);
      split(s[j][2], ah[1], al[1]);
      split(s[j][1], ah[2], al[2]);
      split(s[j][3], ah[3], al[3]);
      const T* v0 = vt + (j * 8 + 2 * t) * P + g;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NG) {
        unsigned bh[NG][2], bl[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          split(widen(v0[(n0 + n) * 8]), bh[n][0], bl[n][0]);
          split(widen(v0[P + (n0 + n) * 8]), bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NG; ++n) mma(acc[n0 + n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < NG; ++n) mma(acc[n0 + n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < NG; ++n) mma(acc[n0 + n], ah, bh[n]);
      }
    }
    __syncthreads();                             // this stage's readers are done
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (gq0 < sq) {
      store(&o[static_cast<long long>(gq0) * op.oss + c], acc[n][0] * inv0);
      store(&o[static_cast<long long>(gq0) * op.oss + c + 1], acc[n][1] * inv0);
    }
    if (gq1 < sq) {
      store(&o[static_cast<long long>(gq1) * op.oss + c], acc[n][2] * inv1);
      store(&o[static_cast<long long>(gq1) * op.oss + c + 1], acc[n][3] * inv1);
    }
  }
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return sizeof(T) * (BQ + 4 * BKV) * pitch<T, HD>();  // Q, two K and two V stages
}

template <typename T, int HD>
int launch_typed(const Operands& op, long long batch_heads, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long q_tiles = (op.sq + BQ - 1) / BQ;
  if (batch_heads <= 0 || q_tiles <= 0 || batch_heads > 2147483647LL || q_tiles > 65535LL ||
      op.sk > 2147483647LL - BKV) {
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
// elements, the head dim is unit stride.  vec: every base pointer and
// every B, H, S stride of q, k and v is a multiple of 16 bytes (16-byte
// copies); else element copies.  Returns a cudaError_t (0 = launched).
extern "C" int helios_flash_attention(int dtype, int hd, int vec, const void* q,
                                      const void* k, const void* v, void* o,
                                      long long batch, int heads, long long sq,
                                      long long sk, int causal, float scale,
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
  op.scale = scale; op.causal = causal; op.vec = vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bh = batch * heads;
  if (dtype == 0) return launch<float>(hd, op, bh, s);
  if (dtype == 1) return launch<__nv_bfloat16>(hd, op, bh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
