// Mamba2 SSD intra-chunk term, by hand for Hopper (sm_90a), on the tensor
// cores with a 3xTF32 split product.
//
// Replaces the Pallas TPU kernel ssd_diag of src/repro/kernels/ssd_scan.py:39
// (body _kernel, :21): per (batch, chunk, head),
//   y[l, p] = sum_{m <= l} (C_l . B_m) * exp(cum[l] - cum[m]) * dtx[m, p]
// with cr, br (B, nc, L, ds), cum (B, nc, L, nh), dtx (B, nc, L, nh, hd) and
// y in dtx's layout and dtype; f32 accumulation.  It is the diagonal-block
// term of the chunked SSD algorithm (models/ssm.py ssd_chunked), which the
// plain version computes with (L, L, nh) decay tensors in device memory.
// There is no backward kernel: as for flash attention, the gradient
// recomputes the plain version under autograd (kernels/ops.py).
//
// What bounds it on the card: at the hybrid slice's shape (B, nc, L, ds,
// nh, hd) = (4, 2, 256, 64, 64, 64), f32, the least work computes C·Bᵀ once
// per (batch, chunk), it has no head axis, and the decayed product once per
// head: 2·L(L+1)/2·(ds + nh·hd) FLOP per (batch, chunk), 2.19 GFLOP in all.
// dtx in and y out are 33.5 MB each, cr, br and cum 1.6 MB: 67 MB, 0.020
// ms at 3.35 TB/s.  On the CUDA cores (67 TFLOP/s of f32 FMA) the
// operations take 0.033 ms; here every product is three TF32 products
// (below), 6.6 GFLOP at the 495 TFLOP/s of dense TF32: 0.013 ms.  So on the
// tensor cores the function is bound by bytes.
//
// Why three products: one TF32 product keeps 10 mantissa bits of each
// operand and misses the port's 1e-4 parity gate (about 5e-4 relative at
// the slice shape).  Each operand x is split into hi = rna_tf32(x) and
// lo = x - hi, which the MMA reads cut to TF32; hi·lo + lo·hi + hi·hi,
// summed in f32 (the two small products first, as CUTLASS's 3xTF32 does),
// lands within about 3e-7 of the f64 product (tests/test_torch_tf32x3.py
// emulates it).  A bf16 operand takes the same path: its hi is exact and
// its lo is 0.
//
// What the design does: two kernels on the caller's stream.
// - ssd_cb_kernel computes S = C·Bᵀ once per (batch, chunk), for every
//   64 × 64 tile on and below the diagonal, with 3xTF32 MMAs over ds, into
//   an f32 workspace the wrapper allocates (b·nc·(64·ceil(L/64))² floats,
//   2 MB at the slice shape, read back from L2).  C·Bᵀ has no head axis,
//   so this is the least work, done once for all heads.
// - ssd_diag_kernel runs one block of four warps per (batch·chunk, head,
//   64-row tile of l); each warp owns 16 rows.  A loop over the m tiles
//   <= the l tile streams each S tile, the head's dtx tile and the head's
//   cum slices through a 16-byte cp.async double buffer (36 KB a stage at
//   ds = hd = 64, so three blocks share an SM).  P_h = S ⊙ exp(cum_l −
//   cum_m) is built from the S tile (ldmatrix) straight into MMA A
//   fragments, split, and multiplied by the dtx tile into the head's
//   accumulators.  (Walking a group of heads per block instead timed the
//   same at two heads and slower at four and eight; keeping the causal
//   strip of C·Bᵀ in shared memory, computed once per group of heads,
//   takes 66 KB a block and holds the kernel to two blocks an SM, beside
//   the strip's own time.)
// - the decay is exponentiated on the kept (m <= l, l < L) entries only:
//   above the diagonal cum[l] - cum[m] is positive and can overflow, and it
//   is never evaluated (its exponent is -inf).  It is never factored as
//   exp(cum_l)·exp(-cum_m), which overflows at the model's chunk of 256;
// - on the diagonal tile warp w skips the 8-column tiles above its last
//   row; ragged L is masked (ragged rows are not stored, ragged columns
//   weigh 0).  Shared rows are padded so that fragment reads are free of
//   bank conflicts.  The operands are read in place through element strides
//   (the last dim of each is unit stride): cr and br carry no head axis,
//   cum has its head at stride 1, dtx and y have (L, nh, hd) strides.
//   Where a view is not 16-byte aligned the same kernels copy element by
//   element (4-byte cp.async for f32, plain loads for bf16); the wrapper
//   passes the flag.  l tiles are issued last tile first, so the longest
//   blocks start first.  No atomics: every call gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BT = 16 * WARPS;         // rows of a tile (l and m alike), 16 a warp
constexpr int SP = BT + 4;             // row pitch of an S tile (f32)
constexpr unsigned NEG_INF_BITS = 0xff800000u;  // -inf

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
// columns t, t + 4)
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
  const void* cr;
  const void* br;
  const float* cum;
  const void* dtx;
  void* y;
  float* cb;                          // workspace: C·Bᵀ per chunk, [tiles·BT]²
  long long cb_size;                  // its length in floats
  int nc, nh;
  int vec;                            // cr, br and dtx rows 16-byte aligned
  long long len;                      // L
  long long csb, csc, csl;            // element strides of cr over B, nc, L
  long long bsb, bsc, bsl;            // br
  long long usb, usc, usl;            // cum (head at stride 1)
  long long xsb, xsc, xsl, xsh;       // dtx over B, nc, L, nh
  long long ysb, ysc, ysl, ysh;       // y
};

// rows [r0, r0 + BT) of a (rows, W) operand with row stride rs into a
// [BT][P] tile; rows at or past `rows` are zero
template <typename T, int W, int P>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs, int r0, int rows,
                                          bool vec, int tid) {
  if (vec) {
    // thread tid copies chunk tid % CPR of rows tid / CPR + RPI·j
    constexpr int PER = 16 / sizeof(T);          // elements per 16-byte chunk
    constexpr int CPR = W / PER;                 // chunks per row
    constexpr int RPI = THREADS / CPR;           // rows per pass
    const int r = tid / CPR, c = (tid % CPR) * PER;
    const T* s = src + static_cast<long long>(r0 + r) * rs + c;
    T* d = dst + r * P + c;
#pragma unroll
    for (int j = 0; j < BT / RPI; ++j) {
      const bool ok = r0 + r + j * RPI < rows;
      cp_async16(d + j * RPI * P, ok ? s + j * RPI * rs : src, ok);
    }
  } else {
    for (int i = tid; i < BT * W; i += THREADS) {
      const int r = i / W, c = i % W;
      const bool ok = r0 + r < rows;
      copy_elem(dst + r * P + c, ok ? src + static_cast<long long>(r0 + r) * rs + c : src, ok);
    }
  }
}

// A fragment (rows 16w + g, + 8; columns c + t, + 4) of a [BT][P] f32 tile
__device__ __forceinline__ void a_frag(float (&a)[4], const float* tile, int P, int c,
                                       int warp, int lane) {
  unsigned r[4];
  ldmatrix_x4(r, tile + (warp * 16 + (lane & 15)) * P + c + (lane >> 4) * 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = __uint_as_float(r[e]);
}
__device__ __forceinline__ void a_frag(float (&a)[4], const __nv_bfloat16* tile, int P, int c,
                                       int warp, int lane) {
  const __nv_bfloat16* p = tile + (warp * 16 + lane / 4) * P + c + lane % 4;
  a[0] = widen(p[0]);
  a[1] = widen(p[8 * P]);
  a[2] = widen(p[4]);
  a[3] = widen(p[8 * P + 4]);
}

// ---------------------------------------------------------------------------
// kernel 1: S = C·Bᵀ once per chunk, for the tiles on and below the diagonal
// ---------------------------------------------------------------------------

template <typename T, int DS>
struct CbLayout {
  static constexpr int P = DS + 16 / static_cast<int>(sizeof(T));  // C and B row pitch
  static constexpr size_t BYTES = sizeof(T) * 2 * BT * P;
};

// one block per (batch·chunk, l tile, m tile <= l tile): 64 × 64 scores,
// every entry written (the zero-filled ragged rows and columns score 0)
template <typename T, int DS>
__global__ void __launch_bounds__(THREADS) ssd_cb_kernel(Operands op, int tiles) {
  constexpr int P = CbLayout<T, DS>::P;
  constexpr int KS = DS / 8;                     // k-steps over ds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);        // [BT][P]
  T* bs = cs + BT * P;                           // [BT][P]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int pairs = tiles * tiles;
  const long long bc = blockIdx.x / pairs;
  const int lt = static_cast<int>(blockIdx.x % pairs) / tiles;
  const int mt = static_cast<int>(blockIdx.x % pairs) % tiles;
  if (mt > lt) return;                           // above the diagonal: never read
  const long long b = bc / op.nc, c = bc % op.nc;
  const int len = static_cast<int>(op.len);
  const bool vec = op.vec != 0;
  const T* cr = static_cast<const T*>(op.cr) + b * op.csb + c * op.csc;
  const T* br = static_cast<const T*>(op.br) + b * op.bsb + c * op.bsc;
  load_tile<T, DS, P>(cs, cr, op.csl, lt * BT, len, vec, tid);
  load_tile<T, DS, P>(bs, br, op.bsl, mt * BT, len, vec, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // per k-step the B fragments first, then each of the three products
  // over every column tile, so that 8 independent MMAs are in flight
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < KS; ++kk) {
    unsigned ah[4], al[4], bh[8][2], bl[8][2];
    float a[4];
    a_frag(a, cs, P, kk * 8, warp, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T* brow = bs + (j * 8 + g) * P + kk * 8 + t;
      split(widen(brow[0]), bh[j][0], bl[j][0]);
      split(widen(brow[4]), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(acc[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(acc[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(acc[j], ah, bh[j]);
  }
  const long long ld = static_cast<long long>(tiles) * BT;
  float* out = op.cb + bc * ld * ld + static_cast<long long>(lt * BT + warp * 16 + g) * ld +
               mt * BT + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(out + j * 8) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + 8 * ld + j * 8) = make_float2(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// kernel 2: y = (S ⊙ decay) · dtx per head
// ---------------------------------------------------------------------------

// a stage: the S tile (l rows × m columns), the head's dtx tile and its cum
// over the tile's m rows and over the block's l rows
template <typename T, int HD>
struct DiagLayout {
  static constexpr int XP = HD + 8;                                 // dtx row pitch
  static constexpr size_t S_TILE = sizeof(float) * BT * SP;
  static constexpr size_t X_TILE = sizeof(T) * BT * XP;
  static constexpr size_t STAGE = S_TILE + X_TILE + sizeof(float) * 2 * BT;
  static constexpr size_t BYTES = 2 * STAGE;
};

// one block per (batch·chunk, head, l tile); a loop over the m tiles <= the
// l tile through a double buffer
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 3 : 2) ssd_diag_kernel(Operands op) {
  using Lay = DiagLayout<T, HD>;
  constexpr int XP = Lay::XP;
  constexpr int NT = HD / 8;                     // 8-column tiles of hd
  constexpr int NG = NT < 4 ? NT : 4;            // output tiles per MMA batch
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;          // MMA group and thread in group
  const long long bc = blockIdx.x / op.nh;
  const int h = static_cast<int>(blockIdx.x % op.nh);
  const long long b = bc / op.nc, c = bc % op.nc;
  // 32-bit row coordinates (the launch keeps L below 2^22); only the
  // address products are 64-bit.  l tiles run last tile first, so the
  // longest blocks start first
  const int lt = gridDim.y - 1 - blockIdx.y;
  const int l0 = lt * BT;
  const int len = static_cast<int>(op.len);
  const bool vec = op.vec != 0;
  const long long ld = static_cast<long long>(gridDim.y) * BT;     // S row stride
  const float* __restrict__ cb = op.cb + bc * ld * ld + l0 * ld;
  const float* __restrict__ cum = op.cum + b * op.usb + c * op.usc + h;
  const T* __restrict__ x = static_cast<const T*>(op.dtx) + b * op.xsb + c * op.xsc + h * op.xsh;
  T* __restrict__ y = static_cast<T*>(op.y) + b * op.ysb + c * op.ysc + h * op.ysh;

  const int lr = warp * 16 + g;                  // this thread's rows lr, lr + 8
  const int gl0 = l0 + lr, gl1 = gl0 + 8;
  const int n_mt = lt + 1;                       // causal: m tiles 0 .. lt

  auto load_tiles = [&](int mt, int st) {
    unsigned char* base = smem_raw + st * Lay::STAGE;
    float* sv = reinterpret_cast<float*>(base);
    T* xt = reinterpret_cast<T*>(base + Lay::S_TILE);
    float* cmv = reinterpret_cast<float*>(base + Lay::S_TILE + Lay::X_TILE);
    const int m0 = mt * BT;
    // the S tile: always 16-byte aligned rows, every entry written
    load_tile<float, BT, SP>(sv, cb + m0, ld, 0, BT, true, tid);
    load_tile<T, HD, XP>(xt, x, op.xsl, m0, len, vec, tid);
    const int gr = tid < BT ? m0 + tid : l0 + (tid - BT);           // BT m rows, BT l rows
    const bool ok = gr < len;
    copy_elem(cmv + tid, ok ? cum + static_cast<long long>(gr) * op.usl : cum, ok);
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  load_tiles(0, 0);
  cp_async_commit();
  for (int mt = 0; mt < n_mt; ++mt) {
    const int st = mt & 1;
    if (mt + 1 < n_mt) {
      load_tiles(mt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* base = smem_raw + st * Lay::STAGE;
    const float* sv = reinterpret_cast<const float*>(base);
    const T* xt = reinterpret_cast<const T*>(base + Lay::S_TILE);
    const float* cmv = reinterpret_cast<const float*>(base + Lay::S_TILE + Lay::X_TILE);
    const float* clv = cmv + BT;
    const int m0 = mt * BT;
    const float cl0 = clv[lr], cl1 = clv[lr + 8];
    // 8-column tiles past this warp's last row are all masked
    const int jmax = min(7, (l0 + warp * 16 + 15 - m0) / 8);
    // a tile wholly below the diagonal and inside L keeps every entry
    const bool full = m0 + BT <= l0 && l0 + BT <= len;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j > jmax) continue;                    // P is 0 there
      const int ma = j * 8 + t, mb = ma + 4;     // contraction slots t, t + 4
      float sa[4];                               // S at rows g, g+8, slots t, t+4
      a_frag(sa, sv, SP, j * 8, warp, lane);
      float d[4] = {cl0 - cmv[ma], cl1 - cmv[ma], cl0 - cmv[mb], cl1 - cmv[mb]};
      if (!full) {
        // exponents of dropped entries are -inf (S is finite, so they
        // weigh 0): never exp of a positive above-diagonal difference
        const int gma = m0 + ma, gmb = m0 + mb;
        const float ninf = __uint_as_float(NEG_INF_BITS);
        if (!(gma <= gl0 && gl0 < len)) d[0] = ninf;
        if (!(gma <= gl1 && gl1 < len)) d[1] = ninf;
        if (!(gmb <= gl0 && gl0 < len)) d[2] = ninf;
        if (!(gmb <= gl1 && gl1 < len)) d[3] = ninf;
      }
      unsigned ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(sa[e] * expf(d[e]), ah[e], al[e]);
      // dtx's fragments NG output tiles at a time, then the three
      // products over those NG tiles
      const T* x0 = xt + ma * XP + g;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NG) {
        unsigned bh[NG][2], bl[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          split(widen(x0[(n0 + n) * 8]), bh[n][0], bl[n][0]);
          split(widen(x0[4 * XP + (n0 + n) * 8]), bh[n][1], bl[n][1]);
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
  for (int n = 0; n < NT; ++n) {
    const int cc = n * 8 + 2 * t;
    if (gl0 < len) {
      store(&y[static_cast<long long>(gl0) * op.ysl + cc], acc[n][0]);
      store(&y[static_cast<long long>(gl0) * op.ysl + cc + 1], acc[n][1]);
    }
    if (gl1 < len) {
      store(&y[static_cast<long long>(gl1) * op.ysl + cc], acc[n][2]);
      store(&y[static_cast<long long>(gl1) * op.ysl + cc + 1], acc[n][3]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DS, int HD>
int launch_typed(const Operands& op, long long chunks, cudaStream_t stream) {
  const long long tiles = (op.len + BT - 1) / BT;
  const long long blocks = chunks * op.nh;
  if (blocks <= 0 || tiles <= 0 || blocks > 2147483647LL || tiles > 65535LL ||
      chunks * tiles * tiles > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (op.cb_size < chunks * tiles * tiles * BT * BT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = set_smem(ssd_cb_kernel<T, DS>, CbLayout<T, DS>::BYTES);
  if (err == cudaSuccess) err = set_smem(ssd_diag_kernel<T, HD>, DiagLayout<T, HD>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_cb_kernel<T, DS><<<static_cast<unsigned>(chunks * tiles * tiles), THREADS,
                         CbLayout<T, DS>::BYTES, stream>>>(op, static_cast<int>(tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  ssd_diag_kernel<T, HD><<<grid, THREADS, DiagLayout<T, HD>::BYTES, stream>>>(op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DS>
int launch_hd(int hd, const Operands& op, long long chunks, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_typed<T, DS, 16>(op, chunks, stream);
    case 32: return launch_typed<T, DS, 32>(op, chunks, stream);
    case 64: return launch_typed<T, DS, 64>(op, chunks, stream);
    case 128: return launch_typed<T, DS, 128>(op, chunks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(int ds, int hd, const Operands& op, long long chunks, cudaStream_t stream) {
  switch (ds) {
    case 16: return launch_hd<T, 16>(hd, op, chunks, stream);
    case 32: return launch_hd<T, 32>(hd, op, chunks, stream);
    case 64: return launch_hd<T, 64>(hd, op, chunks, stream);
    case 128: return launch_hd<T, 128>(hd, op, chunks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype (of cr, br, dtx and y): 0 = float32, 1 = bfloat16; cum is float32.
// ds, hd in {16, 32, 64, 128}.  cb: an f32 workspace of cb_size >= batch·nc·(64·ceil(L/64))²
// floats for C·Bᵀ.  vec: the base pointers and the B, nc, L (and nh for dtx) strides
// of cr, br and dtx are multiples of 16 bytes (16-byte copies); else
// element copies.  Strides are in elements; the last dim of every operand
// is unit stride.  Launches two kernels on `stream`; returns a cudaError_t
// (0 = launched).
extern "C" int helios_ssd_diag(int dtype, int ds, int hd, int vec,
                               const void* cr, const void* br, const float* cum,
                               const void* dtx, void* y, float* cb, long long cb_size,
                               long long batch, int nc, int nh, long long len,
                               long long csb, long long csc, long long csl,
                               long long bsb, long long bsc, long long bsl,
                               long long usb, long long usc, long long usl,
                               long long xsb, long long xsc, long long xsl, long long xsh,
                               long long ysb, long long ysc, long long ysl, long long ysh,
                               void* stream) {
  Operands op;
  op.cr = cr; op.br = br; op.cum = cum; op.dtx = dtx; op.y = y;
  op.cb = cb; op.cb_size = cb_size;
  op.nc = nc; op.nh = nh; op.vec = vec; op.len = len;
  op.csb = csb; op.csc = csc; op.csl = csl;
  op.bsb = bsb; op.bsc = bsc; op.bsl = bsl;
  op.usb = usb; op.usc = usc; op.usl = usl;
  op.xsb = xsb; op.xsc = xsc; op.xsl = xsl; op.xsh = xsh;
  op.ysb = ysb; op.ysc = ysc; op.ysl = ysl; op.ysh = ysh;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = batch * nc;
  if (dtype == 0) return launch<float>(ds, hd, op, chunks, s);
  if (dtype == 1) return launch<__nv_bfloat16>(ds, hd, op, chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
