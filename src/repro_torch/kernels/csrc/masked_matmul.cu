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
// What they compute, in every configuration: IEEE f32 FMA with an f32
// accumulator (no TF32); bf16 inputs widened on load and the result rounded
// once on store.  The wrapper compacts the live mask blocks into a list of
// indices.  The column kernel launches thread blocks for live output tiles
// only (a tile reads the index of the mask block it lies in and never
// crosses into the next one); its dead columns keep the zeros the wrapper
// allocated, or get them from the split-K reduce.  The dk kernel walks only
// the live contraction blocks in its K loop.  Operands may be row- or column-major views with any pitch
// (the backward pass hands over transposes without copying); ragged M, N
// and K edges are masked in the loads and stores.
//
// What bounds them on the card depends on M, so the wrapper's plan() picks
// one of three configurations from the shapes before launching:
//
// * TILE128 (f32, M >= 128, mask block a multiple of 128, 16-byte aligned
//   operands and pitches): the LM's MLP products, M K N among 2048, 4096
//   and 11008, are bound by operations (~1.4 ms at the 67 TFLOP/s f32 FMA
//   peak at P = 0.5).  A 128 x 128 output tile per block of 256 threads,
//   each thread holding 8 x 8 accumulators as 2 x 2 fragments of 4 x 4, so
//   one k step reads its 8 + 8 operands with four 16-byte shared loads for
//   64 FMAs.  The operands pass through a 3-stage ring of 16-deep k-major
//   stages in dynamic shared memory (50 KB; one __syncthreads a stage).
//   An operand whose contiguous dim is the tile's contiguous dim
//   (column-major x, row-major w) is copied with 16-byte cp.async two
//   stages ahead; the other one (row-major x, column-major w) is read with
//   16-byte loads along K one stage ahead into registers, two lanes a row,
//   and stored transposed.  Tile coordinates are 32-bit, which keeps every
//   instantiation within the 128 registers of two blocks an SM, unspilled.
// * SPLITK (M < 128: AlexNet's fc0 and fc1 at batch 32): with 32 rows a
//   product is bound by the bytes of its live weights, and a grid of output
//   tiles alone leaves most of the 132 SMs idle.  The grid adds S splits of
//   the contraction (the column kernel: K ranges of at least 128; the dk
//   kernel: whole live blocks), up to two waves.  Each split writes its
//   partial tile to an f32 workspace (S, M, N); a second kernel sums the
//   splits in fixed order and stores every column (the column kernel's
//   dead ones as 0), rounding bf16 once.  No atomics: a call gives the same
//   bits every time.  Where no split is possible (S = 1) the tile writes y
//   directly.
// * GENERAL (the rest: bf16 at M >= 128, a mask block that is not a multiple
//   of 128, a misaligned pointer or pitch): the SPLITK tile at S = 1.
//
// The SPLITK / GENERAL tile: 32 x 64 outputs, 128 threads of 4 x 4, 32-deep
// stages double-buffered in shared memory.  f32 elements are copied with
// 4-byte cp.async (16-byte for a row-major, aligned w), bf16 ones read into
// registers one stage ahead and widened; the thread order keeps global
// reads coalesced and transposed shared stores free of bank conflicts.
//
// The three share the column-tile map (col_tile), the contraction walk
// (KWalk) and the widen / store helpers.  No wgmma or TMA yet.
//
// The client axis (helios_masked_matmul_clients / _dk_clients) is the
// counterpart of the Pallas pair under jax.vmap, where pallas_call's
// batching rule runs one launch for a whole cohort, each client with its own
// alive flags.  y[c] = x[c] @ w[c] for c < C, with client c's dead blocks
// skipped: the same tiles, instantiated with CLIENTS = true, on a grid
// whose x dimension is C · tiles_m (blockIdx.x = c · tiles_m + row tile, so
// neither 65535 limit of y and z binds the cohort).  Client c reads
// x + c·scx, w + c·scw (a stride of 0 shares one operand with the whole
// cohort), writes y + c·M·N, and walks row c of a (C, nb) table of live
// block indices (ascending, counts[c] of them); the grid's column tiles
// cover every block a client could have, and a tile past its client's count
// exits.  The split-K workspace is (S, C, M, N), summed in fixed order as in
// the single-client reduce.  The client axis's own operands (Cohort) are a
// second kernel parameter, which the CLIENTS = false instantiations never
// read, and they never write Operands or reference it mutably: they compile
// to the single-client kernels as they were.  (Client fields inside
// Operands, written through a mutable reference, cut the single-client f32
// split-K kernels from 158 to 128 registers, 14 % slower on an H100.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// configuration ids, as CONFIGS in masked_matmul.py
constexpr int GENERAL = 0, TILE128 = 1, SPLITK = 2;

// the general / split-K tile: 8 x 16 threads, each 4 rows x 4 columns
constexpr int GTHREADS = 128, BM = 32, BN = 64, BK = 32, GSTAGES = 2;
constexpr int XROW = BM + 4, WROW = BN + 4;
// the large tile and the reduce
constexpr int THREADS = 256;
// the large tile: 16 x 16 threads, each 8 rows x 8 columns
constexpr int LBM = 128, LBN = 128, LBK = 16, STAGES = 3;
// +4 floats a k row: keeps every row's chunks 16-byte aligned
constexpr int LPAD = 4;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Operands {
  const void* x;       // (m, k), element strides sxm, sxk
  const void* w;       // (k, n), element strides swk, swn
  void* y;             // (m, n), row-major, contiguous
  float* ws;           // split-K workspace (splits, m, n), or null
  const int* live;     // indices of the live mask blocks, ascending
  long long m, n, k;
  long long sxm, sxk, swk, swn;
  int n_live;          // length of `live`
  int block;           // mask block width (columns, or contraction rows)
  int splits;          // grid.z
  long long k_split;   // per split: contraction rows (column kernel) or
                       // live blocks (dk kernel)
};

// The client axis: client c reads x + c·scx, w + c·scw, writes y + c·m·n
// and its workspace rows, and walks live + c·sl with counts[c·scn] entries.
struct Cohort {
  const int* counts;
  long long scx, scw, sl, scn;
  int clients;         // C (1 for the single-client entry points)
  int tiles_m;         // row tiles a client: blockIdx.x = c·tiles_m + tile
};

// Client c's view of the operands (blockIdx.x names the client and its row
// tile); returns the row tile.  Called by the CLIENTS instantiations only.
template <typename T>
__device__ __forceinline__ int client_view(Operands& op, const Cohort& co) {
  const int c = blockIdx.x / co.tiles_m;
  op.x = static_cast<const T*>(op.x) + c * co.scx;
  op.w = static_cast<const T*>(op.w) + c * co.scw;
  op.y = static_cast<T*>(op.y) + c * op.m * op.n;
  if (op.ws) op.ws += c * op.m * op.n;   // split z then adds z·C·m·n
  op.live += c * co.sl;
  op.n_live = co.counts[c * co.scn];
  return blockIdx.x % co.tiles_m;
}

// Output columns [n0, n1) of column tile t, TN wide.  SKIP_K (dk): every
// tile of N.  Otherwise the tiles walk the live mask blocks, ceil(block/TN)
// tiles a block; false for a tile past a ragged block or past N, and
// (CLIENTS) for a tile past its client's live count.
template <int TN, bool SKIP_K, bool CLIENTS = false>
__device__ __forceinline__ bool col_tile(const Operands& op, int t, long long& n0,
                                         long long& n1) {
  if (SKIP_K) {
    n0 = static_cast<long long>(t) * TN;
    n1 = min(n0 + TN, op.n);
  } else {
    const int per = (op.block + TN - 1) / TN;
    if (CLIENTS && t / per >= op.n_live) return false;
    const long long b0 = static_cast<long long>(op.live[t / per]) * op.block;
    n0 = b0 + static_cast<long long>(t % per) * TN;
    n1 = min(min(n0 + TN, b0 + op.block), op.n);
  }
  return n0 < n1;
}

// The TK-deep contraction stages of split s.  Column kernel: rows
// [s·k_split, (s+1)·k_split) ∩ [0, K) in order.  SKIP_K: live blocks
// [s·k_split, (s+1)·k_split) of the list, each in ceil(block/TK) stages.
template <int TK, bool SKIP_K>
struct KWalk {
  long long lo, hi;
  int per, stages;
  __device__ KWalk(const Operands& op, int s) {
    lo = s * op.k_split;
    if (SKIP_K) {
      hi = min(lo + op.k_split, static_cast<long long>(op.n_live));
      per = (op.block + TK - 1) / TK;
      stages = hi > lo ? static_cast<int>(hi - lo) * per : 0;
    } else {
      hi = min(lo + op.k_split, op.k);
      per = 0;
      stages = hi > lo ? static_cast<int>((hi - lo + TK - 1) / TK) : 0;
    }
  }
  // stage i reads contraction rows [k0, min(k0 + TK, k_end))
  __device__ __forceinline__ void stage(const Operands& op, int i, long long& k0,
                                        long long& k_end) const {
    if (SKIP_K) {
      const long long b0 = static_cast<long long>(op.live[lo + i / per]) * op.block;
      k0 = b0 + static_cast<long long>(i % per) * TK;
      k_end = min(b0 + op.block, op.k);
    } else {
      k0 = lo + static_cast<long long>(i) * TK;
      k_end = hi;
    }
  }
};

__device__ __forceinline__ int clamp4(long long v) {
  return static_cast<int>(max(0LL, min(v, 4LL)));
}

// 16-byte async copy global -> shared; the chunk's first `valid` (0..4)
// floats are read, the rest of the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid * 4));
}
// 4-byte async copy global -> shared, or a zero when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// GENERAL and SPLITK: 32 x 64 outputs, 32-deep stages, double-buffered
// ---------------------------------------------------------------------------

// Element i of a stage's x tile: tile row r, contraction c.  Row-major x (k
// contiguous): a warp covers 4 rows x 8 k, which keeps both the global
// reads (32-byte runs) and the transposed shared stores (32 banks) whole.
__device__ __forceinline__ void x_elem(bool x_rows, int i, int& r, int& c) {
  if (x_rows) {
    const int lane = i & 31, q = i >> 5;
    r = (q >> 2) * 4 + (lane >> 3);
    c = (q & 3) * 8 + (lane & 7);
  } else {
    r = i % BM;
    c = i / BM;
  }
}
// Element i of a stage's w tile: contraction r, tile column c; column-major
// w (k contiguous) as x above, 8 k x 4 columns a warp.
__device__ __forceinline__ void w_elem(bool w_rows, int i, int& r, int& c) {
  if (w_rows) {
    r = i / BN;
    c = i % BN;
  } else {
    const int lane = i & 31, q = i >> 5;
    r = (q & 3) * 8 + (lane & 7);
    c = (q >> 2) * 4 + (lane >> 3);
  }
}

template <typename T, bool SKIP_K, bool CLIENTS>
__global__ void __launch_bounds__(GTHREADS) masked_mm_kernel(Operands op, Cohort co) {
  // Double-buffered stages.  f32: each element copied by a 4-byte cp.async
  // one stage ahead.  bf16 (widened on load): read into registers one stage
  // ahead, then stored.  (On the H100 the f32 copies measured faster than
  // the register route, and a third buffer slower.)  Rows padded to a
  // multiple of 4 floats for the 16-byte fragment reads.
  constexpr bool ASYNC = sizeof(T) == sizeof(float);
  __shared__ __align__(16) float xs[GSTAGES][BK][XROW];
  __shared__ __align__(16) float ws[GSTAGES][BK][WROW];
  constexpr int XL = BM * BK / GTHREADS, WL = BK * BN / GTHREADS;
  int tile_m = blockIdx.x;
  if constexpr (CLIENTS) tile_m = client_view<T>(op, co);
  const T* __restrict__ x = static_cast<const T*>(op.x);
  const T* __restrict__ w = static_cast<const T*>(op.w);
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(tile_m) * BM;
  long long n0, n1;
  if (!col_tile<BN, SKIP_K, CLIENTS>(op, blockIdx.y, n0, n1)) return;   // uniform
  const KWalk<BK, SKIP_K> kw(op, blockIdx.z);
  const int n_stages = kw.stages;
  const bool x_rows = op.sxk == 1, w_rows = op.swn == 1;
  // f32 row-major w with 16-byte aligned rows and tile: 16-byte copies
  const bool w_vec = ASYNC && w_rows && op.swk % 4 == 0 && n0 % 4 == 0 &&
                     (reinterpret_cast<unsigned long long>(op.w) & 15) == 0;
  float xr[XL], wr[WL];   // bf16 only

  // stage s into buffer `slot` (f32) or into the registers (bf16)
  auto fetch = [&](int s, int slot) {
    long long k0, k_end;
    kw.stage(op, s, k0, k_end);
#pragma unroll
    for (int j = 0; j < XL; ++j) {
      int r, c;
      x_elem(x_rows, tid + j * GTHREADS, r, c);
      const long long gm = m0 + r, gk = k0 + c;
      const bool ok = gm < op.m && gk < k_end;
      const T* src = ok ? x + gm * op.sxm + gk * op.sxk : x;
      if constexpr (ASYNC) {
        cp_async4(&xs[slot][c][r], reinterpret_cast<const float*>(src), ok);
      } else {
        xr[j] = ok ? widen(*src) : 0.f;
      }
    }
    if (w_vec) {
#pragma unroll
      for (int j = 0; j < WL / 4; ++j) {
        const int q = tid + j * GTHREADS, r = q / (BN / 4), c = (q % (BN / 4)) * 4;
        const long long gk = k0 + r, gn = n0 + c;
        const int valid = gk < k_end ? clamp4(n1 - gn) : 0;
        const float* wf = reinterpret_cast<const float*>(w);
        cp_async16(&ws[slot][r][c], valid ? wf + gk * op.swk + gn : wf, valid);
      }
    } else {
#pragma unroll
      for (int j = 0; j < WL; ++j) {
        int r, c;
        w_elem(w_rows, tid + j * GTHREADS, r, c);
        const long long gk = k0 + r, gn = n0 + c;
        const bool ok = gk < k_end && gn < n1;
        const T* src = ok ? w + gk * op.swk + gn * op.swn : w;
        if constexpr (ASYNC) {
          cp_async4(&ws[slot][r][c], reinterpret_cast<const float*>(src), ok);
        } else {
          wr[j] = ok ? widen(*src) : 0.f;
        }
      }
    }
    if constexpr (ASYNC) cp_async_commit();
  };
  auto put = [&](int slot) {   // the registers into a buffer (bf16)
#pragma unroll
    for (int j = 0; j < XL; ++j) {
      int r, c;
      x_elem(x_rows, tid + j * GTHREADS, r, c);
      xs[slot][c][r] = xr[j];
    }
#pragma unroll
    for (int j = 0; j < WL; ++j) {
      int r, c;
      w_elem(w_rows, tid + j * GTHREADS, r, c);
      ws[slot][r][c] = wr[j];
    }
  };

  if (n_stages > 0) {
    fetch(0, 0);
    if constexpr (!ASYNC) put(0);
  }
  // each thread: rows ty*4 .. +3, columns tx*4 .. +3
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int s = 0; s < n_stages; ++s) {
    if constexpr (ASYNC) cp_async_wait<0>();
    __syncthreads();                // stage s landed; stage s-1 is consumed
    const int slot = s % GSTAGES, other = (s + 1) % GSTAGES;
    const bool next = s + 1 < n_stages;
    if (next) fetch(s + 1, other);  // in flight during this stage's FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[slot][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[slot][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if constexpr (!ASYNC) {
      if (next) put(other);
    }
  }
  // split-K: the partial tile goes to the split's workspace slab, in f32
  float* part = op.ws ? op.ws + static_cast<long long>(blockIdx.z) * (CLIENTS ? co.clients : 1) *
                                    op.m * op.n
                      : nullptr;
  T* y = static_cast<T*>(op.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = m0 + ty * 4 + i;
    if (gm >= op.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gn = n0 + tx * 4 + j;
      if (gn >= n1) continue;
      if (part) {
        part[gm * op.n + gn] = acc[i][j];
      } else {
        store(&y[gm * op.n + gn], acc[i][j]);
      }
    }
  }
}

// Whether mask block b is in the (ascending) live list.
__device__ __forceinline__ bool is_live(const Operands& op, long long b) {
  int lo = 0, hi = op.n_live;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (op.live[mid] < b) lo = mid + 1; else hi = mid;
  }
  return lo < op.n_live && op.live[lo] == b;
}

// y[r, n] = Σ_s ws[s, r, n] over the splits in order; the column kernel's
// dead columns are written 0 here (y is not zero-filled).  One thread an
// element (CLIENTS: of y[c, r, n], from client c's live list).
template <typename T, bool SKIP_K, bool CLIENTS>
__global__ void __launch_bounds__(THREADS) splitk_reduce(Operands op, Cohort co) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= (CLIENTS ? co.clients : 1) * op.m * op.n) return;
  T* y = static_cast<T*>(op.y) + i;
  if constexpr (CLIENTS && !SKIP_K) {   // element i is client c's
    const long long c = i / (op.m * op.n);
    op.live += c * co.sl;
    op.n_live = co.counts[c * co.scn];
  }
  if (!SKIP_K && !is_live(op, (i % op.n) / op.block)) {
    store(y, 0.f);
    return;
  }
  const long long slab = (CLIENTS ? co.clients : 1) * op.m * op.n;
  float s = op.ws[i];
#pragma unroll 8
  for (int z = 1; z < op.splits; ++z) s += op.ws[z * slab + i];   // loads run ahead
  store(y, s);
}

// ---------------------------------------------------------------------------
// TILE128: 128 x 128 outputs, 16-deep stages in a 3-stage ring, f32
// ---------------------------------------------------------------------------

// p[0..3], of which the first `valid` exist; the others read as 0
__device__ __forceinline__ float4 load4(const float* p, int valid) {
  if (valid >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = __ldg(p);
  if (valid > 1) v.y = __ldg(p + 1);
  if (valid > 2) v.z = __ldg(p + 2);
  return v;
}

// One operand's stage in shared memory, k-major: LBK rows of 128 + LPAD
constexpr int LROW = LBM + LPAD;
constexpr int LSTAGE = LBK * LROW;
constexpr size_t LSMEM = 2 * STAGES * LSTAGE * sizeof(float);
// 16-byte chunks a thread moves per operand and stage
constexpr int LCHUNKS = LBK * LBM / 4 / THREADS;
// lanes that read one row's chunks in the register route
constexpr int LPR = 2;   // 2 and 4 measured alike; 2 stores without bank conflicts

// A_CP: x is column-major (m contiguous) and is copied with cp.async; else
// x is row-major and staged through registers.  B_CP: w is row-major (n
// contiguous) and copied with cp.async; else column-major, through registers.
template <bool A_CP, bool B_CP, bool SKIP_K, bool CLIENTS>
__global__ void __launch_bounds__(THREADS, 2) masked_mm_tile128(Operands op, Cohort co) {
  extern __shared__ __align__(16) float smem[];
  float* const as = smem;                        // [STAGES][LBK][LROW]
  float* const bs = smem + STAGES * LSTAGE;
  // tile coordinates fit in 32 bits (each below a tensor dim); only the
  // address products are 64-bit, which keeps the kernel within its 128
  // registers
  int tile_m = blockIdx.x;
  if constexpr (CLIENTS) tile_m = client_view<float>(op, co);
  const float* __restrict__ x = static_cast<const float*>(op.x);
  const float* __restrict__ w = static_cast<const float*>(op.w);
  const int tid = threadIdx.x;
  const int m0 = tile_m * LBM;
  long long tile_n0, tile_n1;
  if (!col_tile<LBN, SKIP_K, CLIENTS>(op, blockIdx.y, tile_n0, tile_n1)) return;   // uniform
  const int n0 = static_cast<int>(tile_n0), n1 = static_cast<int>(tile_n1);
  const int m = static_cast<int>(op.m);
  const KWalk<LBK, SKIP_K> kw(op, 0);
  const int n_stages = kw.stages;

  // copy roles of chunk q = tid + j·THREADS.  cp.async: k row q/32 of the
  // stage, tile columns (q%32)·4 .. +3.  Registers: 4 contraction values,
  // from k kq(q), of tile row (or column) row(q); LPR neighbouring lanes
  // read one row's consecutive chunks (fewer cache lines a warp load).
  float4 ra[LCHUNKS], rb[LCHUNKS];
  auto row = [](int q) { return (q / LPR) % LBM; };
  auto kq = [](int q) { return 4 * (q % LPR + LPR * (q / (LBM * LPR))); };

  auto copy_async = [&](int slot, int k0, int k_end) {
#pragma unroll
    for (int j = 0; j < LCHUNKS; ++j) {
      const int q = tid + j * THREADS, cr = q >> 5, cc = (q & 31) * 4;
      const int gk = k0 + cr;
      const int at = (slot * LBK + cr) * LROW + cc;
      if (A_CP) {
        const int gm = m0 + cc;
        const int valid = gk < k_end ? clamp4(m - gm) : 0;
        cp_async16(as + at, valid ? x + gm + gk * op.sxk : x, valid);
      }
      if (B_CP) {
        const int gn = n0 + cc;
        const int valid = gk < k_end ? clamp4(n1 - gn) : 0;
        cp_async16(bs + at, valid ? w + gk * op.swk + gn : w, valid);
      }
    }
  };
  auto load_regs = [&](int k0, int k_end) {
#pragma unroll
    for (int j = 0; j < LCHUNKS; ++j) {
      const int q = tid + j * THREADS;
      const int gk = k0 + kq(q);
      if (!A_CP) {
        const int gm = m0 + row(q);
        ra[j] = load4(x + gm * op.sxm + gk, gm < m ? clamp4(k_end - gk) : 0);
      }
      if (!B_CP) {
        const int gn = n0 + row(q);
        rb[j] = load4(w + gn * op.swn + gk, gn < n1 ? clamp4(k_end - gk) : 0);
      }
    }
  };
  auto store_regs = [&](int slot) {
#pragma unroll
    for (int j = 0; j < LCHUNKS; ++j) {
      const int q = tid + j * THREADS;
      const int at = (slot * LBK + kq(q)) * LROW + row(q);
      if (!A_CP) {
        as[at] = ra[j].x; as[at + LROW] = ra[j].y;
        as[at + 2 * LROW] = ra[j].z; as[at + 3 * LROW] = ra[j].w;
      }
      if (!B_CP) {
        bs[at] = rb[j].x; bs[at + LROW] = rb[j].y;
        bs[at + 2 * LROW] = rb[j].z; bs[at + 3 * LROW] = rb[j].w;
      }
    }
  };

  long long k0, k_end;
  if ((!A_CP || !B_CP) && n_stages > 0) {
    kw.stage(op, 0, k0, k_end);
    load_regs(static_cast<int>(k0), static_cast<int>(k_end));
    store_regs(0);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if ((A_CP || B_CP) && s < n_stages) {
      kw.stage(op, s, k0, k_end);
      copy_async(s, static_cast<int>(k0), static_cast<int>(k_end));
    }
    cp_async_commit();
  }

  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage i landed
    __syncthreads();               // everyone's did; stage i-1 is consumed
    const int ahead = i + STAGES - 1;
    if ((A_CP || B_CP) && ahead < n_stages) {   // into the slot stage i-1 used
      kw.stage(op, ahead, k0, k_end);
      copy_async(ahead % STAGES, static_cast<int>(k0), static_cast<int>(k_end));
    }
    cp_async_commit();
    const bool next = i + 1 < n_stages;
    if ((!A_CP || !B_CP) && next) {
      kw.stage(op, i + 1, k0, k_end);
      load_regs(static_cast<int>(k0), static_cast<int>(k_end));   // in flight during the FMAs
    }
    const float* const sa = as + (i % STAGES) * LSTAGE;
    const float* const sb = bs + (i % STAGES) * LSTAGE;
#pragma unroll
    for (int kk = 0; kk < LBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * LROW + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + kk * LROW + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * LROW + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * LROW + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    // the slot of stage i+1 last held stage i+1-STAGES, consumed before
    // this stage's __syncthreads
    if ((!A_CP || !B_CP) && next) store_regs((i + 1) % STAGES);
  }

  float* __restrict__ y = static_cast<float*>(op.y);
  const bool vec = (op.n & 3) == 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gm = m0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
    if (gm >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      float* out = y + gm * op.n + gn;
      if (vec && gn + 4 <= n1) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gn + c < n1) out[c] = acc[r][4 * h + c];
      }
    }
  }
}

template <bool A_CP, bool B_CP, bool SKIP_K, bool CLIENTS>
cudaError_t launch_tile128_as(const Operands& op, const Cohort& co, dim3 grid,
                              cudaStream_t stream) {
  // A ring above 48 KB needs the opt-in, made once per device and kept
  // off the launch path.
  constexpr int kDevices = 64;
  static bool opted[kDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    rc = cudaFuncSetAttribute(masked_mm_tile128<A_CP, B_CP, SKIP_K, CLIENTS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(LSMEM));
    if (rc != cudaSuccess) return rc;
    opted[dev] = true;
  }
  masked_mm_tile128<A_CP, B_CP, SKIP_K, CLIENTS><<<grid, THREADS, LSMEM, stream>>>(op, co);
  return cudaGetLastError();
}

template <bool SKIP_K, bool CLIENTS>
cudaError_t launch_tile128(const Operands& op, const Cohort& co, dim3 grid,
                           cudaStream_t stream) {
  const bool a_cp = op.sxm == 1, b_cp = op.swn == 1;
  if (a_cp && b_cp) return launch_tile128_as<true, true, SKIP_K, CLIENTS>(op, co, grid, stream);
  if (a_cp) return launch_tile128_as<true, false, SKIP_K, CLIENTS>(op, co, grid, stream);
  if (b_cp) return launch_tile128_as<false, true, SKIP_K, CLIENTS>(op, co, grid, stream);
  return launch_tile128_as<false, false, SKIP_K, CLIENTS>(op, co, grid, stream);
}

template <typename T, bool SKIP_K, bool CLIENTS>
cudaError_t launch_tiles(const Operands& op, const Cohort& co, dim3 grid,
                         cudaStream_t stream) {
  masked_mm_kernel<T, SKIP_K, CLIENTS><<<grid, GTHREADS, 0, stream>>>(op, co);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || op.ws == nullptr) return rc;
  const long long blocks = (co.clients * op.m * op.n + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  splitk_reduce<T, SKIP_K, CLIENTS>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(op, co);
  return cudaGetLastError();
}

// The grid is (clients · tiles_m, tiles_n, splits), as the wrapper's plan()
// made it.
template <bool SKIP_K, bool CLIENTS>
int launch(int dtype, int config, const Operands& op, const Cohort& co, int tiles_m,
           int tiles_n, cudaStream_t stream) {
  if (tiles_m <= 0 || tiles_n <= 0 || tiles_n > 65535 || op.splits <= 0 ||
      op.splits > 65535 || op.k_split <= 0 || co.clients <= 0 ||
      (!CLIENTS && co.clients != 1) ||
      static_cast<long long>(tiles_m) * co.clients > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (CLIENTS && co.counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool split = op.splits > 1;
  if (split != (op.ws != nullptr) || (split && config != SPLITK) ||
      (config == TILE128 && dtype != 0) || dtype < 0 || dtype > 1 || config < GENERAL ||
      config > SPLITK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(tiles_m * co.clients), static_cast<unsigned>(tiles_n),
                  static_cast<unsigned>(op.splits));
  if (config == TILE128) {
    return static_cast<int>(launch_tile128<SKIP_K, CLIENTS>(op, co, grid, stream));
  }
  return static_cast<int>(
      dtype == 0 ? launch_tiles<float, SKIP_K, CLIENTS>(op, co, grid, stream)
                 : launch_tiles<__nv_bfloat16, SKIP_K, CLIENTS>(op, co, grid, stream));
}

Operands pack(const void* x, const void* w, void* y, void* ws, const int* live, int n_live,
              int block, long long m, long long n, long long k, long long sxm, long long sxk,
              long long swk, long long swn, int splits, long long k_split) {
  Operands op;
  op.x = x; op.w = w; op.y = y; op.ws = static_cast<float*>(ws); op.live = live;
  op.m = m; op.n = n; op.k = k;
  op.sxm = sxm; op.sxk = sxk; op.swk = swk; op.swn = swn;
  op.n_live = n_live; op.block = block; op.splits = splits; op.k_split = k_split;
  return op;
}

// The single-client entry points' cohort: one client, never read.
constexpr Cohort kOneClient = {nullptr, 0, 0, 0, 0, 1, 0};

// The client axis: `counts` holds the (clients,) live counts of the (clients,
// nb) table of live indices, with strides scn and sl.
Cohort cohort(const int* counts, int clients, long long scx, long long scw, long long sl,
              long long scn, int tiles_m) {
  return Cohort{counts, scx, scw, sl, scn, clients, tiles_m};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  config: GENERAL / TILE128 / SPLITK.
// ws: the (splits, m, n) f32 workspace when splits > 1, else null.
// Returns a cudaError_t (0 = launched).
extern "C" int helios_masked_matmul(int dtype, int config, const void* x, const void* w,
                                    void* y, void* ws, const int* live, int n_live,
                                    int block_n, long long m, long long n, long long k,
                                    long long sxm, long long sxk, long long swk,
                                    long long swn, int tiles_m, int tiles_n, int splits,
                                    long long k_split, void* stream) {
  return launch<false, false>(dtype, config,
                              pack(x, w, y, ws, live, n_live, block_n, m, n, k, sxm, sxk, swk,
                                   swn, splits, k_split),
                              kOneClient, tiles_m, tiles_n, static_cast<cudaStream_t>(stream));
}

extern "C" int helios_masked_matmul_dk(int dtype, int config, const void* x, const void* w,
                                       void* y, void* ws, const int* live, int n_live,
                                       int block_k, long long m, long long n, long long k,
                                       long long sxm, long long sxk, long long swk,
                                       long long swn, int tiles_m, int tiles_n, int splits,
                                       long long k_split, void* stream) {
  return launch<true, false>(dtype, config,
                             pack(x, w, y, ws, live, n_live, block_k, m, n, k, sxm, sxk, swk,
                                  swn, splits, k_split),
                             kOneClient, tiles_m, tiles_n, static_cast<cudaStream_t>(stream));
}

// The client axis: y[c] = x[c] @ w[c] for c < clients, x + c·scx (m, k) and
// w + c·scw (k, n) with the element strides above, y (clients, m, n)
// row-major, live a (clients, nb) int32 table of each client's live block
// indices (ascending, counts[c·scn] of them, row stride sl); ws the
// (splits, clients, m, n) f32 workspace when splits > 1, else null.
// tiles_m is a client's row tiles (the grid's x is clients · tiles_m);
// tiles_n covers nb blocks.
extern "C" int helios_masked_matmul_clients(int dtype, int config, const void* x,
                                            const void* w, void* y, void* ws,
                                            const int* live, const int* counts, int nb,
                                            int block_n, int clients, long long m, long long n,
                                            long long k, long long scx, long long sxm,
                                            long long sxk, long long scw, long long swk,
                                            long long swn, long long sl, long long scn,
                                            int tiles_m, int tiles_n, int splits,
                                            long long k_split, void* stream) {
  return launch<false, true>(dtype, config,
                             pack(x, w, y, ws, live, nb, block_n, m, n, k, sxm, sxk, swk, swn,
                                  splits, k_split),
                             cohort(counts, clients, scx, scw, sl, scn, tiles_m), tiles_m,
                             tiles_n, static_cast<cudaStream_t>(stream));
}

extern "C" int helios_masked_matmul_dk_clients(int dtype, int config, const void* x,
                                               const void* w, void* y, void* ws,
                                               const int* live, const int* counts, int nb,
                                               int block_k, int clients, long long m,
                                               long long n, long long k, long long scx,
                                               long long sxm, long long sxk, long long scw,
                                               long long swk, long long swn, long long sl,
                                               long long scn, int tiles_m, int tiles_n,
                                               int splits, long long k_split, void* stream) {
  return launch<true, true>(dtype, config,
                            pack(x, w, y, ws, live, nb, block_k, m, n, k, sxm, sxk, swk, swn,
                                 splits, k_split),
                            cohort(counts, clients, scx, scw, sl, scn, tiles_m), tiles_m,
                            tiles_n, static_cast<cudaStream_t>(stream));
}
