// Mamba2 SSD intra-chunk term, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_diag of src/repro/kernels/ssd_scan.py:39
// (body _kernel, :21): per (batch, chunk, head),
//   y[l, p] = sum_{m <= l} (C_l . B_m) * exp(cum[l] - cum[m]) * dtx[m, p]
// with cr, br (B, nc, L, ds), cum (B, nc, L, nh), dtx (B, nc, L, nh, hd) and
// y in dtx's layout and dtype; f32 arithmetic.  It is the diagonal-block
// term of the chunked SSD algorithm (models/ssm.py ssd_chunked), which the
// plain version computes with (L, L, nh) decay tensors in device memory.
// There is no backward kernel: as for flash attention, the gradient
// recomputes the plain version under autograd (kernels/ops.py).
//
// What bounds it on the card: at the hybrid slice's shape (B, nc, L, ds,
// nh, hd) = (4, 2, 256, 64, 64, 64), f32, the two products over the causal
// half are L(L+1)/2 * (ds + hd) FMAs per (batch, chunk, head), 4.3 GFLOP in
// all as this kernel computes them (C.B is recomputed for every head): 0.064
// ms at the H100's 67 TFLOP/s of f32 FMA on the CUDA cores (no TF32, for
// parity with the reference).  C.B has no head axis, so the least work
// computes it once per chunk: 2.2 GFLOP, 0.033 ms.  dtx in and y out are
// 33.5 MB each, C, B and cum 1.6 MB, 0.021 ms at 3.35 TB/s.  So it is bound
// by operations.
//
// What the design does about it: the Pallas kernel holds one (chunk,
// head)'s whole (L, L) score and decay tiles in VMEM; at L = 256 one f32
// (L, L) tile is 256 KB, more than the 227 KB of shared memory a Hopper
// block may use.  So this is the loop of the flash kernel without the
// softmax: one thread block of 256 threads per (batch·chunk·head, 64-row
// tile of l), a loop inside the block over 64-row tiles of m up to the
// diagonal.  The C rows and cum values of the l tile stay in shared memory
// for the whole loop; each B tile, dtx tile and cum slice is staged once
// and used by all 64 rows.  Each thread owns a 4x4 block of the 64x64 score
// tile and a 4 x hd/16 block of the output (the same 4 rows), kept in
// registers.  Each score C_l.B_m is scaled by exp(cum[l] - cum[m]) only
// where m <= l: above the diagonal that difference is positive and can
// overflow, and it is never evaluated, so no inf appears.  Ragged L is
// masked: ragged rows are not stored and ragged columns score 0.  The
// operands are read in place through element strides (the last dim of
// each is unit stride): cr and br carry no head axis, cum has its head at
// stride 1, dtx and y have (L, nh, hd) strides, so no permuted copy is
// made.  bf16 inputs are widened on load and rounded once on store.  This
// is the simple first version: IEEE f32 FMA on the CUDA cores, no wgmma, no
// cp.async, no sharing of C.B across heads, no skipping of masked heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BL = 64;         // l rows per thread block
constexpr int BM = 64;         // m rows per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16; each thread owns 4 rows

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Operands {
  const void* cr;
  const void* br;
  const float* cum;
  const void* dtx;
  void* y;
  int nc, nh;
  long long len;                      // L
  long long csb, csc, csl;            // element strides of cr over B, nc, L
  long long bsb, bsc, bsl;            // br
  long long usb, usc, usl;            // cum (head at stride 1)
  long long xsb, xsc, xsl, xsh;       // dtx over B, nc, L, nh
  long long ysb, ysc, ysl, ysh;       // y
};

template <typename T, int DS, int HD>
__global__ void __launch_bounds__(THREADS) ssd_diag_kernel(Operands op) {
  constexpr int CP = DS + 1;           // padded row pitch of the C and B tiles
  constexpr int PP = BM + 1;           // padded row pitch of the score tile
  constexpr int CJ = HD / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* cs = smem;                    // [BL][CP]
  float* bs = cs + BL * CP;            // [BM][CP]
  float* xs = bs + BM * CP;            // [BM][HD]
  float* ps = xs + BM * HD;            // [BL][PP]
  float* cl = ps + BL * PP;            // [BL] cum of the l rows
  float* cm = cl + BL;                 // [BM] cum of the m rows

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bc = blockIdx.x / op.nh;
  const long long h = blockIdx.x % op.nh;
  const long long b = bc / op.nc, c = bc % op.nc;
  const long long l0 = static_cast<long long>(blockIdx.y) * BL;
  const long long len = op.len;
  const T* __restrict__ cr = static_cast<const T*>(op.cr) + b * op.csb + c * op.csc;
  const T* __restrict__ br = static_cast<const T*>(op.br) + b * op.bsb + c * op.bsc;
  const float* __restrict__ cum = op.cum + b * op.usb + c * op.usc + h;
  const T* __restrict__ x = static_cast<const T*>(op.dtx) + b * op.xsb + c * op.xsc + h * op.xsh;
  T* __restrict__ y = static_cast<T*>(op.y) + b * op.ysb + c * op.ysc + h * op.ysh;

  for (int i = tid; i < BL * DS; i += THREADS) {
    const int r = i / DS, d = i % DS;
    const long long gl = l0 + r;
    cs[r * CP + d] = gl < len ? widen(cr[gl * op.csl + d]) : 0.f;
  }
  for (int i = tid; i < BL; i += THREADS) {
    const long long gl = l0 + i;
    cl[i] = gl < len ? cum[gl * op.usl] : 0.f;
  }

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  // causal: the last m any row of this tile sees is min(l0+BL, L)-1
  const long long m_end = min(l0 + BL, len);
  for (long long m0 = 0; m0 < m_end; m0 += BM) {
    __syncthreads();                   // the last stage's readers are done
    for (int i = tid; i < BM * DS; i += THREADS) {
      const int r = i / DS, d = i % DS;
      const long long gm = m0 + r;
      bs[r * CP + d] = gm < len ? widen(br[gm * op.bsl + d]) : 0.f;
    }
    for (int i = tid; i < BM * HD; i += THREADS) {
      const int r = i / HD, p = i % HD;
      const long long gm = m0 + r;
      xs[r * HD + p] = gm < len ? widen(x[gm * op.xsl + p]) : 0.f;
    }
    for (int i = tid; i < BM; i += THREADS) {
      const long long gm = m0 + i;
      cm[i] = gm < len ? cum[gm * op.usl] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DS; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = cs[(ty + 16 * i) * CP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = bs[(tx + 16 * j) * CP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

    // the decay, evaluated on the kept (m <= l, m < L) entries only
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const long long gl = l0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        const long long gm = m0 + q;
        float p = 0.f;
        if (gm <= gl && gm < len) p = s[i][j] * expf(cl[r] - cm[q]);
        ps[r * PP + q] = p;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BM; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float xv = xs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], xv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gl = l0 + ty + 16 * i;
    if (gl >= len) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) store(&y[gl * op.ysl + tx + 16 * j], acc[i][j]);
  }
}

template <int DS, int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BL * (DS + 1) + BM * (DS + 1) + BM * HD + BL * (BM + 1) + BL + BM);
}

template <typename T, int DS, int HD>
int launch_typed(const Operands& op, long long groups, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DS, HD>();
  cudaError_t err = cudaFuncSetAttribute(ssd_diag_kernel<T, DS, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long l_tiles = (op.len + BL - 1) / BL;
  if (groups <= 0 || l_tiles <= 0 || groups > 2147483647LL || l_tiles > 65535LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(l_tiles));
  ssd_diag_kernel<T, DS, HD><<<grid, THREADS, bytes, stream>>>(op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DS>
int launch_hd(int hd, const Operands& op, long long groups, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_typed<T, DS, 16>(op, groups, stream);
    case 32: return launch_typed<T, DS, 32>(op, groups, stream);
    case 64: return launch_typed<T, DS, 64>(op, groups, stream);
    case 128: return launch_typed<T, DS, 128>(op, groups, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(int ds, int hd, const Operands& op, long long groups, cudaStream_t stream) {
  switch (ds) {
    case 16: return launch_hd<T, 16>(hd, op, groups, stream);
    case 32: return launch_hd<T, 32>(hd, op, groups, stream);
    case 64: return launch_hd<T, 64>(hd, op, groups, stream);
    case 128: return launch_hd<T, 128>(hd, op, groups, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype (of cr, br, dtx and y): 0 = float32, 1 = bfloat16; cum is float32.
// ds, hd in {16, 32, 64, 128}.  Strides are in elements; the last dim of
// every operand is unit stride.  Returns a cudaError_t (0 = launched).
extern "C" int helios_ssd_diag(int dtype, int ds, int hd, const void* cr, const void* br,
                               const float* cum, const void* dtx, void* y, long long batch,
                               int nc, int nh, long long len,
                               long long csb, long long csc, long long csl,
                               long long bsb, long long bsc, long long bsl,
                               long long usb, long long usc, long long usl,
                               long long xsb, long long xsc, long long xsl, long long xsh,
                               long long ysb, long long ysc, long long ysl, long long ysh,
                               void* stream) {
  Operands op;
  op.cr = cr; op.br = br; op.cum = cum; op.dtx = dtx; op.y = y;
  op.nc = nc; op.nh = nh; op.len = len;
  op.csb = csb; op.csc = csc; op.csl = csl;
  op.bsb = bsb; op.bsc = bsc; op.bsl = bsl;
  op.usb = usb; op.usc = usc; op.usl = usl;
  op.xsb = xsb; op.xsc = xsc; op.xsl = xsl; op.xsh = xsh;
  op.ysb = ysb; op.ysc = ysc; op.ysl = ysl; op.ysh = ysh;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long groups = batch * nc * nh;
  if (dtype == 0) return launch<float>(ds, hd, op, groups, s);
  if (dtype == 1) return launch<__nv_bfloat16>(ds, hd, op, groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
