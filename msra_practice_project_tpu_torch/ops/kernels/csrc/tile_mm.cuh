// Building blocks shared by the port's MLP kernels (nerf_mlp.cu, film_mlp.cu):
// the per-tile layer product of the fp32 check mode on the CUDA cores, the
// deterministic split-K dW = act^T delta with its fixed-order sum, the bf16
// per-tile pass's machinery on wgmma (section "bf16 per-tile pass").
//
// fp32 (layer_mm): a group of NT threads (a whole CTA of THREADS, or one
// warpgroup of it synchronised by its own named barrier) owns a tile of TM
// points.  Its activations live in shared memory (row stride HID + pad);
// each layer's weights stream through shared memory in KS-row slices
// (cp.async double buffer) and the product is accumulated by FMA on the
// CUDA cores.  Each output element sums its products in the same order
// whatever NT and TM are.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tile_mm {

typedef __nv_bfloat16 bf16_t;

constexpr int HID = 256;
constexpr int THREADS = 256;
constexpr int KS = 32;  // weight rows per shared-memory slice

template <typename T> __host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16_t>::value;
}
template <typename T> __host__ __device__ constexpr int pad16() {
  return 16 / (int)sizeof(T);
}
// a weight slice: [KS][HID + pad] (W), or [HID][KS + pad] (TRANS, W^T)
template <typename T, bool TRANS>
__host__ __device__ constexpr int wstage_of() {
  return TRANS ? HID * (KS + pad16<T>()) : KS * (HID + pad16<T>());
}
// a slice of either layout
template <typename T> __host__ __device__ constexpr int wstage() {
  return wstage_of<T, false>() > wstage_of<T, true>() ? wstage_of<T, false>()
                                                      : wstage_of<T, true>();
}
constexpr int CLD = HID + 4;  // fp32 accumulator staging row stride

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16_t>(bf16_t v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16_t from_f<bf16_t>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA
}

__device__ __forceinline__ void cp16(void* s, const void* g) {
  unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g) : "memory");
}
// copies 16 bytes, or writes 16 zero bytes when !valid
__device__ __forceinline__ void cp16_zfill(void* s, const void* g,
                                           bool valid) {
  unsigned a = (unsigned)__cvta_generic_to_shared(s);
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(g), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The barrier of a group of NT threads: __syncthreads for the whole CTA, else
// named barrier BAR (1..15) of one warpgroup.
template <int NT, int BAR>
__device__ __forceinline__ void group_sync() {
  if constexpr (NT == THREADS) {
    __syncthreads();
  } else {
    static_assert(BAR > 0 && BAR < 16 && NT % 32 == 0, "named barrier");
    asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(NT) : "memory");
  }
}

// One product of a layer: A [TM, k] in shared memory (row stride lda) times
// W [k, nout] (row-major in global memory), or, with TRANS, times W^T where
// W is [nout, k] row-major.
template <typename T> struct Operand {
  const T* a;
  int lda;
  int k;
  const T* w;
};

template <typename T, bool TRANS, int NT>
__device__ __forceinline__ void load_slice(const Operand<T>& op, int k0,
                                           int nout, T* wb, int tid) {
  constexpr int V = pad16<T>();
  if (!TRANS) {
    const int ldw = nout + pad16<T>(), cpr = nout / V;
    for (int c = tid; c < KS * cpr; c += NT) {
      const int r = c / cpr, col = (c % cpr) * V;
      cp16(wb + r * ldw + col, op.w + (size_t)(k0 + r) * nout + col);
    }
  } else {
    constexpr int ldw = KS + pad16<T>(), cpr = KS / V;
    for (int c = tid; c < nout * cpr; c += NT) {
      const int n = c / cpr, col = (c % cpr) * V;
      cp16(wb + n * ldw + col, op.w + (size_t)n * op.k + k0 + col);
    }
  }
}

// C[TM, nout] (fp32, row stride CLD) = sum over ops of A @ W (or A @ W^T),
// by the group of NT threads (barrier BAR) that owns these TM rows; wbuf
// holds two slices (2 * wstage_of<T, TRANS>()).  nout is 256 or 128.
// Starts and ends with the group synchronised.  fp32 only: the bf16
// products run on wgmma (tc_product).
template <typename T, int TM, bool TRANS, int NT = THREADS, int BAR = 0>
__device__ void layer_mm(const Operand<T>* ops, int n_ops, int nout, T* wbuf,
                         float* C) {
  static_assert(!is_bf16<T>(), "bf16 products run on wgmma");
  const int tid = threadIdx.x % NT;
  const int n0 = ops[0].k / KS;
  const int S = n0 + (n_ops > 1 ? ops[1].k / KS : 0);
  auto slice = [&](int s, const Operand<T>*& op, int& k0) {
    if (s < n0) { op = &ops[0]; k0 = s * KS; }
    else { op = &ops[1]; k0 = (s - n0) * KS; }
  };
  constexpr int STAGE = wstage_of<T, TRANS>();
  {
    const Operand<T>* op; int k0;
    slice(0, op, k0);
    load_slice<T, TRANS, NT>(*op, k0, nout, wbuf, tid);
    cp_commit();
  }
  // fp32 check mode: a thread owns cpt columns, ct apart (ct threads
  // across the columns), and `rows` rows of them
  constexpr int NC = HID / NT > 1 ? HID / NT : 1;
  const int ct = nout < NT ? nout : NT, cpt = nout / ct;
  const int rows = TM / (NT / ct);
  const int c0 = tid % ct, r0 = (tid / ct) * rows;
  float acc[NC][TM];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[j][r] = 0.f;
  for (int s = 0; s < S; ++s) {
    if (s + 1 < S) {
      const Operand<T>* op; int k0;
      slice(s + 1, op, k0);
      load_slice<T, TRANS, NT>(*op, k0, nout, wbuf + ((s + 1) & 1) * STAGE,
                               tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    group_sync<NT, BAR>();
    const T* wb = wbuf + (s & 1) * STAGE;
    const Operand<T>* op; int k0;
    slice(s, op, k0);
    for (int k = 0; k < KS; ++k) {
      const T* a = op->a + r0 * op->lda + k0 + k;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (j < cpt) {
          const int col = c0 + j * ct;
          const float w = TRANS ? to_f(wb[col * (KS + pad16<T>()) + k])
                                : to_f(wb[k * (nout + pad16<T>()) + col]);
#pragma unroll
          for (int r = 0; r < TM; ++r)
            if (r < rows) acc[j][r] += to_f(a[r * op->lda]) * w;
        }
      }
    }
    group_sync<NT, BAR>();
  }
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (j < cpt)
#pragma unroll
      for (int r = 0; r < TM; ++r)
        if (r < rows) C[(r0 + r) * CLD + c0 + j * ct] = acc[j][r];
  group_sync<NT, BAR>();
}

// ---------------------------------------------------------------------------
// Split-K dW = act^T delta (db = 1^T delta) and the fixed-order sum of splits
// ---------------------------------------------------------------------------
//
// It replaces the dW accumulation of the Pallas kernels' sequential grids:
// msra_practice_project_tpu/ops/pallas/nerf_mlp.py::_grad_body (K2, K5) and
// the dW part of film_mlp.py::_bwd_kernel (K7).  For every task (a0, M, d0,
// N, off): dW[m, n] = sum_p act[p, a0 + m] delta[p, d0 + n], or db[n] =
// sum_p delta[p, d0 + n] when a0 = -1.  Each split owns a fixed range of
// points (chunks_per_split chunks of PK) and writes an fp32 partial
// partials[split][off + m N + n]; sum_splits_kernel adds the splits in split
// order, so repeats are bitwise equal and a pass over chunks of whole splits
// (K5, K7) gives the whole pass's partials.
//
// bf16 (dw_splitk_tc_kernel).  Bound on an H100: the bytes, each used act
// and delta column read once (K2: 9,952 B per point, ~0.78 ms at the NeRF
// step's 262,144 points at 3.35 TB/s, against ~0.32 ms of bf16 tensor-core
// work).  Design: a CTA owns up to 128 (X) x 256 (Y) outputs of one task (a
// "job"), X the weight's rows and Y its columns, or, for a task whose N is
// not a multiple of 64 (the 8-wide heads), X the delta columns and Y the act
// columns; so a 256 x 256 weight reads each act column once and each delta
// column twice (the two X halves of one task are neighbouring CTAs, so the
// second read tends to come from L2): K2's tasks load ~16 KB per point, K7's
// ~15 KB.  A bias task is folded into the job of the first weight task with
// the same delta columns: db is a fixed-order column sum of the delta tiles
// that CTA already holds, so bias tasks read nothing of their own.  One
// producer warp keeps a ring of DW_STAGES stages in flight with TMA (2-D
// tensor maps over acts and deltas, boxes of PK points x 64 columns, 128-byte
// swizzle; a box past the row end is zero-filled, and the columns past M or N
// only feed outputs that are not written); each stage reports on an
// mbarrier.  Two consumer warpgroups, each 64 X rows, run wgmma.m64nNk16
// (N = 128 or 256) with both operands MN-major in shared memory (points are
// the contraction dimension of both), release the stage when their wgmmas
// have retired, and write the fp32 accumulators straight from registers.
//
// fp32 check mode (dw_splitk_f32_kernel): 64 x 64 output tiles, cp.async
// copies and FMA on the CUDA cores.

constexpr int MAX_TASKS = 32;
struct Tasks {
  int n;
  int v[MAX_TASKS][5];  // act col (-1: ones), M, delta col, N, out offset
  int tile_start[MAX_TASKS + 1];
};
constexpr int TT = 64;         // fp32 output tile edge
constexpr int PK = 32;         // points per chunk (a split is whole chunks)
constexpr int DW_THREADS = 128;

// Fills the tile table from `tasks` (n_tasks rows of 5 ints); returns the
// extent of the flat gradient the tasks write (max offset + M * N).
inline int make_tasks(const int* tasks, int n_tasks, Tasks& tk) {
  tk.n = n_tasks;
  tk.tile_start[0] = 0;
  int total = 0;
  for (int t = 0; t < n_tasks; ++t) {
    for (int j = 0; j < 5; ++j) tk.v[t][j] = tasks[t * 5 + j];
    const int M = tk.v[t][1], N = tk.v[t][3];
    tk.tile_start[t + 1] =
        tk.tile_start[t] + ((M + TT - 1) / TT) * ((N + TT - 1) / TT);
    if (tk.v[t][4] + M * N > total) total = tk.v[t][4] + M * N;
  }
  return total;
}

constexpr size_t dw_f32_smem() {
  return 2 * 2 * (size_t)PK * (TT + pad16<float>()) * sizeof(float)
         + (size_t)TT * TT * 4;
}

// fp32: grid (tiles of all tasks, splits): each CTA owns one 64x64 output
// tile and the fixed point range of its split (cps chunks of PK points, the
// last split's possibly fewer or none), and writes an fp32 partial
// (partials[split][total]).  acts/deltas are row-major with row strides
// act_ld/delta_ld; n_pts is a multiple of PK.
__global__ void __launch_bounds__(DW_THREADS)
dw_splitk_f32_kernel(const float* __restrict__ acts, int act_ld,
                     const float* __restrict__ deltas, int delta_ld,
                     float* __restrict__ partials, int n_pts, int cps,
                     int total, Tasks tk) {
  constexpr int LD = TT + pad16<float>(), V = pad16<float>(), CPR = TT / V;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [2][PK][LD]
  float* Ds = As + 2 * PK * LD;                // [2][PK][LD]
  float* Cs = Ds + 2 * PK * LD;                // [TT][TT]

  int t = 0;
  while ((int)blockIdx.x >= tk.tile_start[t + 1]) ++t;
  const int a0 = tk.v[t][0], M = tk.v[t][1], d0 = tk.v[t][2],
            N = tk.v[t][3], off = tk.v[t][4];
  const int local = (int)blockIdx.x - tk.tile_start[t], ntn = (N + TT - 1) / TT;
  const int m0 = (local / ntn) * TT, n0 = (local % ntn) * TT;
  const int n_chunks = n_pts / PK;
  const int c_lo = min((int)blockIdx.y * cps, n_chunks);
  const int c_hi = min(c_lo + cps, n_chunks);

  if (a0 < 0) {  // bias: a column of ones
    for (int i = threadIdx.x; i < 2 * PK * LD; i += DW_THREADS)
      As[i] = (i % LD) == 0 ? 1.f : 0.f;
  }
  auto load = [&](int c, int b) {
    for (int i = threadIdx.x; i < PK * CPR; i += DW_THREADS) {
      const int p = i / CPR, col = (i % CPR) * V;
      const size_t pt = (size_t)c * PK + p;
      if (a0 >= 0)
        cp16_zfill(As + (b * PK + p) * LD + col,
                   acts + pt * act_ld + a0 + m0 + col, m0 + col < M);
      cp16_zfill(Ds + (b * PK + p) * LD + col,
                 deltas + pt * delta_ld + d0 + n0 + col, n0 + col < N);
    }
    cp_commit();
  };

  const int n = threadIdx.x % TT, mb = (threadIdx.x / TT) * 32;
  float acc[32];
#pragma unroll
  for (int m = 0; m < 32; ++m) acc[m] = 0.f;
  if (c_lo < c_hi) load(c_lo, 0);
  for (int c = c_lo; c < c_hi; ++c) {
    const int b = (c - c_lo) & 1;
    if (c + 1 < c_hi) { load(c + 1, b ^ 1); cp_wait<1>(); }
    else { cp_wait<0>(); }
    __syncthreads();
    const float* A = As + b * PK * LD;
    const float* D = Ds + b * PK * LD;
    for (int p = 0; p < PK; ++p) {
      const float d = D[p * LD + n];
#pragma unroll
      for (int m = 0; m < 32; ++m) acc[m] += A[p * LD + mb + m] * d;
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 32; ++m) Cs[(mb + m) * TT + n] = acc[m];
  __syncthreads();
  float* dst = partials + (size_t)blockIdx.y * (size_t)total + off;
  for (int i = threadIdx.x; i < TT * TT; i += DW_THREADS) {
    const int m = i / TT, n = i % TT;
    if (m0 + m < M && n0 + n < N) dst[(m0 + m) * N + n0 + n] = Cs[i];
  }
}

// --- bf16: TMA, mbarriers and wgmma ----------------------------------------

constexpr int DW_STAGES = 8;
constexpr int DW_BOX = 64;                    // columns per TMA box: 128 B
constexpr int DW_BOX_BYTES = PK * DW_BOX * 2;  // 4096
constexpr int DW_XB = 2, DW_YB = 4;           // boxes per stage: X, Y
constexpr int DW_STAGE_BYTES = (DW_XB + DW_YB) * DW_BOX_BYTES;
constexpr int DW_CONSUMERS = 256;             // two warpgroups
constexpr int DW_TC_THREADS = DW_CONSUMERS + 32;  // and one producer warp
constexpr size_t DW_TC_SMEM =
    1024 + (size_t)DW_STAGES * DW_STAGE_BYTES + 2 * DW_STAGES * 8;
static_assert(DW_TC_SMEM <= 232448, "split-K ring exceeds shared memory");

// One CTA's share of a task: X columns [x0, x0 + xm) (xm <= 128) against Y
// columns [y0, y0 + yn) (yn <= 256); output (x, y) goes to partial index
// off + x sx + y sy.  With X_DELTA, X is read from the deltas and Y from
// the acts.  boff >= 0: the CTA also writes db[j] = sum_p delta column j
// (j < bn) to partial index boff + j.
constexpr int MAX_JOBS = 64;
constexpr int X_DELTA = 1;
struct DwJob {
  int x0, xm, y0, yn, off, sx, sy, flags, boff, bn;
};
struct DwJobs {
  int n;
  DwJob j[MAX_JOBS];
};

// The jobs of a task table, weight tasks in order, X halves of a task
// adjacent; false when they exceed MAX_JOBS or a bias task shares its delta
// columns (d0, N) with no weight task whose first job holds them all.
inline bool make_jobs(const Tasks& tk, DwJobs& js) {
  js.n = 0;
  int first[MAX_TASKS];
  for (int t = 0; t < tk.n; ++t) {
    const int a0 = tk.v[t][0], M = tk.v[t][1], d0 = tk.v[t][2],
              N = tk.v[t][3], off = tk.v[t][4];
    first[t] = -1;
    if (a0 < 0) continue;
    const bool swap = N % DW_BOX != 0 && M > N;
    const int xc = swap ? d0 : a0, xn = swap ? N : M;
    const int yc = swap ? a0 : d0, yn = swap ? M : N;
    const int sx = swap ? 1 : N, sy = swap ? N : 1;
    first[t] = js.n;
    for (int x = 0; x < xn; x += 2 * DW_BOX)
      for (int y = 0; y < yn; y += 4 * DW_BOX) {
        if (js.n == MAX_JOBS) return false;
        js.j[js.n++] = DwJob{xc + x, min(2 * DW_BOX, xn - x), yc + y,
                             min(4 * DW_BOX, yn - y), off + x * sx + y * sy,
                             sx, sy, swap ? X_DELTA : 0, -1, 0};
      }
  }
  for (int t = 0; t < tk.n; ++t) {
    if (tk.v[t][0] >= 0) continue;
    const int d0 = tk.v[t][2], N = tk.v[t][3];
    int u = 0;
    while (u < tk.n && !(first[u] >= 0 && tk.v[u][2] == d0
                         && tk.v[u][3] == N))
      ++u;
    if (u == tk.n) return false;
    DwJob& j = js.j[first[u]];
    const int held = (j.flags & X_DELTA) ? j.xm : j.yn;
    if (j.boff >= 0 || held != N) return false;
    j.boff = tk.v[t][4];
    j.bn = N;
  }
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits for the phase of parity `parity` to complete.  A wait that lasts
// ~2^34 cycles (seconds) traps, so a lost arrival fails the launch instead
// of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (i == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// A box of the 2-D tensor map at (column c0, row c1) into shared memory at
// dst, completing on mbarrier bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A box of shared memory at src to the 2-D tensor map at (column c0, row
// c1), in this thread's bulk group; the box's shared memory may be reused
// after bulk_wait_read<0>, and its writes are done after bulk_wait<0>.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0,
                                             int c1, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// The wgmma descriptor of an operand with 128-byte swizzle at shared
// address addr (1024-byte aligned atoms).  MN-major: rows of 64 MN elements
// (128 B) per contraction index, 8-row atoms `sbo` bytes apart along the
// contraction, 64-element MN blocks `lbo` bytes apart.  K-major (the FiLM
// trunk's A): rows of 64 contraction elements per MN index, 8-row atoms
// `sbo` bytes apart along MN, `lbo` unused; a k16 step inside the 128-byte
// row advances addr by 32 B.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
         | (uint64_t)1 << 62;  // 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// until at most N committed wgmma groups of this thread are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma operand reads, TMA); precedes the barrier the readers wait on
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64, N] += A[64, 16] B[16, N]: bf16 operands, fp32 accumulators; A and B
// in shared memory, both MN-major (transpose bits set), scale-d 1.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64, 256] (+)= A[64, 16] B[16, 256]: as wgmma_m64n128k16, B MN-major;
// A MN-major when TA = 1 (the split-K pass), K-major when TA = 0 (the FiLM
// trunk's activations); accumulate = 0 ignores D's old values.
template <int TA = 1>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA));
}

template <int NY>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (NY == 256) wgmma_m64n256k16(d, da, db);
  else wgmma_m64n128k16(d, da, db);
}

// --- tf32 on wgmma (the fp32 forwards' 3xTF32 products) --------------------
//
// An fp32 product to fp32 accuracy as three tf32 tensor-core products: a =
// big(a) + small(a) with big(a) = a rounded to tf32 (tf32_big) and small(a)
// = a - big(a) (exact); A B ~ big(A) big(B) + small(A) big(B) + big(A)
// small(B), the dropped small(A) small(B) ~2^-22 of the product.  The
// tensor cores ignore the low 13 bits of a tf32 operand, so small is used
// truncated to tf32.  PTX allows wgmma's transpose bits only for 16-bit
// types, so both tf32 operands are K-major (128-byte rows of 32 fp32 of K,
// 8-row atoms 1,024 B apart, 128-byte swizzle; a k8 step advances the
// descriptor's address by 32 B).

// v rounded to tf32: to nearest, ties away from zero (film_mlp.py's
// tf32_split does the same bit arithmetic on the host)
__device__ __forceinline__ float tf32_big(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// D[64, 128] (+)= A[64, 8] B[8, 128]: tf32 operands, fp32 accumulators; A
// and B K-major in shared memory; accumulate = 0 ignores D's old values.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float* d, uint64_t da,
                                                     uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64, 64] (+)= A[64, 8] B[8, 64]: as wgmma_m64n128k8_tf32.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float* d, uint64_t da,
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// A stage: X boxes at 0 and DW_BOX_BYTES, Y boxes from 2 DW_BOX_BYTES; in a
// box, point p's 64 columns are 128 bytes at p * 128, their 16-byte chunks
// permuted by the swizzle (chunk ^ p % 8).
__device__ __forceinline__ int swizzled(int p, int col) {
  return p * 128 + ((((col >> 3) ^ p) & 7) << 4) + (col & 7) * 2;
}

// The consumers' loop and epilogue for a job of NY (128 or 256) Y columns.
template <int NY>
__device__ __forceinline__ void dw_consume(const DwJob& jb, uint32_t ring,
                                           const unsigned char* ring_g,
                                           uint32_t bars, int n_it,
                                           float* __restrict__ dst) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32,
            lane = threadIdx.x % 32;
  const bool mma = wg * DW_BOX < jb.xm;
  const int bcol = threadIdx.x;
  const bool bias = jb.boff >= 0 && bcol < jb.bn;
  const int bbase = ((jb.flags & X_DELTA) ? 0 : DW_XB * DW_BOX_BYTES)
                    + (bcol / DW_BOX) * DW_BOX_BYTES;
  float acc[NY / 2];
#pragma unroll
  for (int i = 0; i < NY / 2; ++i) acc[i] = 0.f;
  float bsum = 0.f;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % DW_STAGES;
    mbar_wait(bars + 8 * s, (it / DW_STAGES) & 1);
    __syncwarp();  // wgmma is .aligned: the warp leaves the wait together
    const uint32_t st = ring + s * DW_STAGE_BYTES;
    if (mma) {
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < PK / 16; ++k)
        wgmma_tile<NY>(
            acc,
            gmma_desc(st + wg * DW_BOX_BYTES + k * 2048, DW_BOX_BYTES, 1024),
            gmma_desc(st + DW_XB * DW_BOX_BYTES + k * 2048, DW_BOX_BYTES,
                      1024));
      wgmma_commit();
      wgmma_wait0();
    }
    if (bias) {
      const unsigned char* b = ring_g + s * DW_STAGE_BYTES + bbase;
#pragma unroll 8
      for (int p = 0; p < PK; ++p)
        bsum += __bfloat162float(*reinterpret_cast<const bf16_t*>(
            b + swizzled(p, bcol % DW_BOX)));
    }
    mbar_arrive(bars + 8 * (DW_STAGES + s));
  }
  // accumulator (row, col) of thread (warp, lane): rows warp * 16 + lane / 4
  // (+ 8), columns 8 j + 2 (lane % 4) (+ 1), register 4 j + 2 h + c
  if (mma) {
    const int r0 = wg * DW_BOX + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < NY / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = r0 + 8 * h, y = 8 * j + 2 * (lane % 4) + c;
          if (x < jb.xm && y < jb.yn)
            dst[jb.off + x * jb.sx + y * jb.sy] = acc[4 * j + 2 * h + c];
        }
  }
  if (bias) dst[jb.boff + bcol] = bsum;
}

// bf16: grid (jobs, splits); each CTA runs one job over its split's point
// range (cps chunks of PK points, the last split's possibly fewer or none)
// and writes its outputs of partials[split][total].  ptxas -v (sm_90a,
// CUDA 12.9): 161 registers, no spills, so setmaxnreg is not needed.
__global__ void __launch_bounds__(DW_TC_THREADS, 1)
dw_splitk_tc_kernel(const __grid_constant__ CUtensorMap act_map,
                    const __grid_constant__ CUtensorMap delta_map,
                    float* __restrict__ partials, int n_pts, int cps,
                    int total, const __grid_constant__ DwJobs jobs) {
  const DwJob jb = jobs.j[blockIdx.x];
  const int n_chunks = n_pts / PK;
  const int c_lo = min((int)blockIdx.y * cps, n_chunks);
  const int n_it = min(c_lo + cps, n_chunks) - c_lo;
  const int nxb = (jb.xm + DW_BOX - 1) / DW_BOX;
  const int nyb = jb.yn <= 2 * DW_BOX ? 2 : 4;

  extern __shared__ unsigned char dw_smem_raw[];
  const uint32_t raw = smem_u32(dw_smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t bars = ring + DW_STAGES * DW_STAGE_BYTES;  // full, empty
  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (DW_STAGES + s), DW_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= DW_CONSUMERS) {  // the producer warp: one thread
    if (threadIdx.x == DW_CONSUMERS) {
      const bool xd = jb.flags & X_DELTA;
      const CUtensorMap* xmap = xd ? &delta_map : &act_map;
      const CUtensorMap* ymap = xd ? &act_map : &delta_map;
      const uint32_t tx = (nxb + nyb) * DW_BOX_BYTES;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % DW_STAGES, row = (c_lo + it) * PK;
        mbar_wait(bars + 8 * (DW_STAGES + s), ((it / DW_STAGES) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * s, tx);
        const uint32_t st = ring + s * DW_STAGE_BYTES;
        for (int b = 0; b < nxb; ++b)
          tma_load_2d(st + b * DW_BOX_BYTES, xmap, jb.x0 + b * DW_BOX, row,
                      bars + 8 * s);
        for (int b = 0; b < nyb; ++b)
          tma_load_2d(st + (DW_XB + b) * DW_BOX_BYTES, ymap,
                      jb.y0 + b * DW_BOX, row, bars + 8 * s);
      }
    }
    return;
  }
  const unsigned char* ring_g = dw_smem_raw + (ring - raw);
  float* dst = partials + (size_t)blockIdx.y * (size_t)total;
  if (nyb == 4)
    dw_consume<256>(jb, ring, ring_g, bars, n_it, dst);
  else
    dw_consume<128>(jb, ring, ring_g, bars, n_it, dst);
}

// ---------------------------------------------------------------------------
// bf16 per-tile pass: two 64-point tiles per CTA on one TMA weight ring
// ---------------------------------------------------------------------------
//
// The machinery of the per-tile kernels of film_mlp.cu (K7's delta chain,
// K8) and nerf_mlp.cu (K1/K3/K6, K2's delta chain).  A CTA has two consumer
// warpgroups, each owning one 64-point tile (global tile 2 blockIdx.x + wg),
// and one producer warpgroup.  The producer's one thread streams a weight
// stack ([rows, 256] bf16, row-major, the rows in the order the products
// read them) through a ring of TC_STAGES stages with TMA: a stage is 32
// K-rows x 256 columns as four 32 x 64 boxes with 128-byte swizzle, so every
// B operand is MN-major as in the split-K pass.  A stage is released when
// both warpgroups have read it (a warpgroup without a tile still waits on
// every full barrier and arrives on every empty one, tc_idle).  Each
// warpgroup keeps its tile's activations as A: [64, 256] bf16, K-major, four
// 8 KB blocks of 64 points x 64 columns, each point's 64 columns one
// 128-byte row swizzled as a TMA box would be (a_offset); other K-major
// operands (a PE block) use the same layout.  A product is wgmma.m64n256k16
// over 32-row slices into 128 fp32 registers per thread: register 4 j + 2 h
// + c holds row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + c.
// The kernels' epilogues work on those registers, walked in blocks
// (acc_block), and overwrite A in place, since the product that read A has
// retired; A then goes to a workspace by TMA (tc_store_a).
//
// Shared memory: [1024-aligned ring | A of warpgroup 0 | A of warpgroup 1 |
// the kernel's own region (`extra` bytes) | full and empty barriers].

constexpr int TC_STAGES = 6;
constexpr int TC_STAGE_BYTES = KS * HID * 2;  // 16384: 32 weight rows
constexpr int TC_TILE = 64;                   // points per warpgroup
constexpr int TC_A_BLOCK = TC_TILE * 64 * 2;  // 8192: 64 points x 64 columns
constexpr int TC_A_BYTES = 4 * TC_A_BLOCK;
constexpr int TC_WG = 128;
constexpr int TC_CONSUMERS = 2 * TC_WG;
// and a producer warpgroup, whose one thread issues the TMA loads: with 384
// threads a thread may hold 168 registers at launch; setmaxnreg moves them
// from the producer (40) to the consumers (232), which hold 128 fp32
// accumulators each through the epilogues.
constexpr int TC_THREADS = TC_CONSUMERS + 128;
constexpr int TC_PRODUCER_REGS = 40, TC_CONSUMER_REGS = 232;
static_assert(TC_CONSUMERS * TC_CONSUMER_REGS
                  + (TC_THREADS - TC_CONSUMERS) * TC_PRODUCER_REGS <= 65536,
              "register file");
static_assert(HID / DW_BOX * DW_BOX_BYTES == TC_STAGE_BYTES, "stage boxes");
// A's descriptor: K-major, 8-point atoms 1,024 B apart (SBO); LBO unused.
constexpr uint32_t TC_A_LBO = 16, TC_A_SBO = 1024;

// The dynamic shared memory of a pass whose own region takes `extra` bytes.
constexpr size_t tc_smem(size_t extra) {
  return 1024 + (size_t)TC_STAGES * TC_STAGE_BYTES + 2 * (size_t)TC_A_BYTES
         + extra + 2 * TC_STAGES * 8;
}

// A's byte offset of (point p, column col)
__device__ __forceinline__ int a_offset(int p, int col) {
  return (col >> 6) * TC_A_BLOCK + swizzled(p, col & 63);
}

// out[i] = acc[4 jb + i] for i < 4 JB, of NACC accumulators; jb a multiple
// of JB, known only at run time (the registers are named at compile time in
// each case).
template <int JB, int NACC = HID / 2>
__device__ __forceinline__ void acc_block(const float* acc, int jb,
                                          float* out) {
  constexpr int N = 4 * JB;
  static_assert(NACC % N == 0 && NACC / N <= 16, "acc_block has 16 cases");
  switch (jb / JB) {
#define TC_ACC_CASE(B)                                \
  case B:                                             \
    if constexpr ((B) * N < NACC) {                   \
      _Pragma("unroll") for (int i = 0; i < N; ++i)   \
        out[i] = acc[(B) * N + i];                    \
    }                                                 \
    break;
    TC_ACC_CASE(0) TC_ACC_CASE(1) TC_ACC_CASE(2) TC_ACC_CASE(3)
    TC_ACC_CASE(4) TC_ACC_CASE(5) TC_ACC_CASE(6) TC_ACC_CASE(7)
    TC_ACC_CASE(8) TC_ACC_CASE(9) TC_ACC_CASE(10) TC_ACC_CASE(11)
    TC_ACC_CASE(12) TC_ACC_CASE(13) TC_ACC_CASE(14) TC_ACC_CASE(15)
#undef TC_ACC_CASE
  }
}

struct TcCtx {
  uint32_t ring, bars;  // shared addresses: the ring; full, then empty
  uint32_t a;           // this warpgroup's A (shared address)
  unsigned char* ag;    // ... and its generic pointer
  float* scr;           // this warpgroup's fp32 scratch (the kernel's)
  int it;               // ring stages consumed so far
  int wg, warp, lane, tid;
  int row0;             // the tile's first row in the workspaces
};

// The kernel's own region, after both As: its shared address and its
// generic pointer.
__device__ __forceinline__ uint32_t tc_ext(const TcCtx& c) {
  return c.a + (2 - (c.wg & 1)) * TC_A_BYTES;
}
__device__ __forceinline__ unsigned char* tc_ext_ptr(const TcCtx& c) {
  return c.ag + (2 - (c.wg & 1)) * TC_A_BYTES;
}

__device__ __forceinline__ void wg_sync(const TcCtx& c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c.wg) : "memory");
}

// acc (+)= A x the next SLICES ring stages (a K of 32 SLICES): A at shared
// address a, K-major as above; accumulate = 0 starts from zero.  Each stage
// is released once its wgmmas have retired.  Ends with the warpgroup
// synchronised, so A may be overwritten.
template <int SLICES>
__device__ __forceinline__ void tc_product(TcCtx& c, float* acc, uint32_t a,
                                           int accumulate) {
  for (int s = 0; s < SLICES; ++s, ++c.it) {
    const int st = c.it % TC_STAGES;
    mbar_wait(c.bars + 8 * st, (c.it / TC_STAGES) & 1);
    __syncwarp();  // wgmma is .aligned
    const uint32_t b = c.ring + st * TC_STAGE_BYTES;
    if (s == 0) wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS / 16; ++k) {
      const int kk = s * (KS / 16) + k;  // k16 step of the product
      wgmma_m64n256k16<0>(
          acc,
          gmma_desc(a + (kk >> 2) * TC_A_BLOCK + (kk & 3) * 32, TC_A_LBO,
                    TC_A_SBO),
          gmma_desc(b + k * 2048, 4096, 1024), accumulate || s + k > 0);
    }
    wgmma_commit();
    if (s > 0) {
      wgmma_wait<1>();
      mbar_arrive(c.bars + 8 * (TC_STAGES + (c.it - 1) % TC_STAGES));
    }
  }
  wgmma_wait0();
  mbar_arrive(c.bars + 8 * (TC_STAGES + (c.it - 1) % TC_STAGES));
  if (c.tid == 0) bulk_wait_read<0>();  // tc_store_a is done with A
  wg_sync(c);
}

// The warpgroup's A (its first `blocks` 64-column blocks) -> the tensor
// map's rows c.row0 + row_off.. and columns col0.. (a workspace), by TMA
// from one thread once A is complete and fenced; the next tc_product waits
// until the copy has read A.
__device__ __forceinline__ void tc_store_a(const TcCtx& c,
                                           const CUtensorMap* map, int col0,
                                           int blocks = HID / DW_BOX,
                                           int row_off = 0) {
  if (c.tid == 0) {
    for (int b = 0; b < blocks; ++b)
      for (int h = 0; h < TC_TILE / PK; ++h)
        tma_store_2d(map, col0 + b * DW_BOX, c.row0 + row_off + h * PK,
                     c.a + b * TC_A_BLOCK + h * PK * 128);
    bulk_commit();
  }
}

// `blocks` 64-column boxes of the tensor map's rows row0.. (a tile) into an
// A-layout buffer at shared address dst, completing on mbarrier bar (whose
// expected bytes the caller sets: DW_BOX_BYTES per box, 2 boxes per block).
__device__ __forceinline__ void tc_load_tile(uint32_t dst,
                                             const CUtensorMap* map,
                                             int col0, int row0, int blocks,
                                             uint32_t bar) {
  for (int b = 0; b < blocks; ++b)
    for (int h = 0; h < TC_TILE / PK; ++h)
      tma_load_2d(dst + b * TC_A_BLOCK + h * PK * 128, map, col0 + b * DW_BOX,
                  row0 + h * PK, bar);
}

// The producer's one thread: the `n` stages (KS rows each) of the stack
// behind `map`, from its row 0, into the ring from stage count `it`;
// returns the count after them.
__device__ __forceinline__ int tc_produce(uint32_t ring, uint32_t bars,
                                          const CUtensorMap* map, int n,
                                          int it) {
  for (int r = 0; r < n; ++r, ++it) {
    const int s = it % TC_STAGES;
    mbar_wait(bars + 8 * (TC_STAGES + s), ((it / TC_STAGES) & 1) ^ 1);
    mbar_expect_tx(bars + 8 * s, TC_STAGE_BYTES);
    const uint32_t st = ring + s * TC_STAGE_BYTES;
    for (int b = 0; b < HID / DW_BOX; ++b)
      tma_load_2d(st + b * DW_BOX_BYTES, map, b * DW_BOX, r * KS,
                  bars + 8 * s);
  }
  return it;
}

// A warpgroup without a tile keeps the ring's count for `n` stages.
__device__ __forceinline__ void tc_idle(const TcCtx& c, int n) {
  for (int it = 0; it < n; ++it) {
    const int s = it % TC_STAGES;
    mbar_wait(c.bars + 8 * s, (it / TC_STAGES) & 1);
    mbar_arrive(c.bars + 8 * (TC_STAGES + s));
  }
}

__device__ __forceinline__ void tc_regs_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TC_PRODUCER_REGS));
}
__device__ __forceinline__ void tc_regs_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TC_CONSUMER_REGS));
}

// The set-up of a pass whose own region takes `extra` bytes (a multiple of
// 8): carves shared memory and initialises the ring's barriers; returns
// this thread's context (scr and row0 unset).
__device__ __forceinline__ TcCtx tc_setup(unsigned char* raw_p, int extra) {
  const uint32_t raw = smem_u32(raw_p);
  TcCtx c;
  c.ring = (raw + 1023) & ~1023u;
  const uint32_t a0 = c.ring + TC_STAGES * TC_STAGE_BYTES;
  c.wg = threadIdx.x / TC_WG;
  c.tid = threadIdx.x % TC_WG;
  c.warp = c.tid / 32;
  c.lane = threadIdx.x % 32;
  c.a = a0 + (c.wg & 1) * TC_A_BYTES;
  c.ag = raw_p + (c.a - raw);
  c.bars = a0 + 2 * TC_A_BYTES + extra;
  c.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(c.bars + 8 * s, 1);
      mbar_init(c.bars + 8 * (TC_STAGES + s), TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return c;
}

// two neighbouring values of a kernel input (read-only for the launch)
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldb2(const bf16_t* p) {
  return __bfloat1622float2(
      __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void stb2(void* p, __nv_bfloat162 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// cuTensorMapEncodeTiled, looked up at run time (libcuda is not linked).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map over `rows` rows of `width` columns that lie `ld`
// elements apart (a column view of wider rows when width < ld), with boxes
// of box_rows rows x 64 columns and 128-byte swizzle (boxes past the row
// end or the last row read zeros).
inline cudaError_t make_view_map(CUtensorMap* map, const void* ptr,
                                 int width, int ld, int rows, int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16_t)};
  const cuuint32_t box[2] = {DW_BOX, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 [rows, ld] row-major tensor map with boxes of PK rows x 64 columns.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int ld,
                            int rows) {
  return make_view_map(map, ptr, ld, ld, rows, PK);
}

// dw = (accumulate ? dw : 0) + sum over splits, in split order.
__global__ void sum_splits_kernel(const float* __restrict__ partials,
                                  float* __restrict__ dw, int total,
                                  int splits, int accumulate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partials[(size_t)k * total + i];
  dw[i] = accumulate ? dw[i] + s : s;
}

// Chunks of PK points per split when n_pts points are cut into `splits`.
inline int chunks_per_split(int n_pts, int splits) {
  return (n_pts / PK + splits - 1) / splits;
}

// The split-K pass alone: `splits` partials of cps chunks each, from n_pts
// points, on `st`; returns the first CUDA error.
template <typename T>
cudaError_t dw_partials(const T* acts, int act_ld, const T* deltas,
                        int delta_ld, float* partials, int n_pts, int splits,
                        int cps, const Tasks& tk, int total, cudaStream_t st) {
  if constexpr (is_bf16<T>()) {
    DwJobs js;
    if (!make_jobs(tk, js)) return cudaErrorInvalidValue;
    CUtensorMap amap, dmap;
    cudaError_t e = make_map(&amap, acts, act_ld, n_pts);
    if (e == cudaSuccess) e = make_map(&dmap, deltas, delta_ld, n_pts);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dw_splitk_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DW_TC_SMEM);
    if (e != cudaSuccess) return e;
    dw_splitk_tc_kernel<<<dim3(js.n, splits), DW_TC_THREADS, DW_TC_SMEM,
                          st>>>(amap, dmap, partials, n_pts, cps, total, js);
  } else {
    constexpr size_t smw = dw_f32_smem();
    cudaError_t e = cudaFuncSetAttribute(
        dw_splitk_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smw);
    if (e != cudaSuccess) return e;
    dw_splitk_f32_kernel<<<dim3(tk.tile_start[tk.n], splits), DW_THREADS, smw,
                           st>>>(acts, act_ld, deltas, delta_ld, partials,
                                 n_pts, cps, total, tk);
  }
  return cudaGetLastError();
}

inline cudaError_t sum_splits(const float* partials, float* dw, int total,
                              int splits, int accumulate, cudaStream_t st) {
  sum_splits_kernel<<<(total + 255) / 256, 256, 0, st>>>(partials, dw, total,
                                                         splits, accumulate);
  return cudaGetLastError();
}

// The split-K pass over n_pts points in `splits` even ranges and its sum on
// `st`; returns the first CUDA error.
template <typename T>
cudaError_t dw_splitk(const T* acts, int act_ld, const T* deltas,
                      int delta_ld, float* partials, float* dw, int n_pts,
                      int splits, const Tasks& tk, int total, int accumulate,
                      cudaStream_t st) {
  cudaError_t e = dw_partials<T>(acts, act_ld, deltas, delta_ld, partials,
                                 n_pts, splits,
                                 chunks_per_split(n_pts, splits), tk, total,
                                 st);
  if (e != cudaSuccess) return e;
  return sum_splits(partials, dw, total, splits, accumulate, st);
}

}  // namespace tile_mm

// The bf16 split-K pass alone, for checks and timings: partials [splits,
// total] and their sum dw [total] from acts [n, act_ld] and deltas [n,
// delta_ld] (16-byte aligned rows) over `tasks` (n_tasks rows of 5 ints:
// act col or -1, M, delta col, N, offset); n a multiple of PK.
extern "C" int tile_mm_dw_splitk_bf16(const void* acts, int act_ld,
                                      const void* deltas, int delta_ld,
                                      float* partials, float* dw, int n,
                                      int splits, const int* tasks,
                                      int n_tasks, void* stream) {
  using namespace tile_mm;
  if (n < PK || n % PK || splits < 1 || n_tasks < 1 || n_tasks > MAX_TASKS
      || act_ld % 8 || delta_ld % 8)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < n_tasks; ++t) {
    const int* v = tasks + 5 * t;
    if ((v[0] >= 0 && v[0] + v[1] > act_ld) || v[2] + v[3] > delta_ld
        || v[1] < 1 || v[3] < 1 || v[4] < 0)
      return (int)cudaErrorInvalidValue;
  }
  Tasks tk;
  const int total = make_tasks(tasks, n_tasks, tk);
  return (int)dw_splitk<bf16_t>(
      static_cast<const bf16_t*>(acts), act_ld,
      static_cast<const bf16_t*>(deltas), delta_ld, partials, dw, n, splits,
      tk, total, 0, reinterpret_cast<cudaStream_t>(stream));
}
