// Building blocks shared by the port's MLP kernels (nerf_mlp.cu, film_mlp.cu):
// the per-tile layer product on the tensor cores, and the deterministic
// split-K dW = act^T delta with its fixed-order sum.
//
// A group of NT threads (a whole CTA of THREADS, or one warpgroup of it
// synchronised by its own named barrier) owns a tile of TM points.  Its
// activations live in shared memory (row stride HID + pad); each layer's
// weights stream through shared memory in KS-row slices (cp.async double
// buffer) and the product is accumulated in fp32 (WMMA bf16 on the tensor
// cores, or FMA on the CUDA cores in the fp32 check mode, T = float).  Each
// output element sums its products in the same order whatever NT and TM are.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace tile_mm {

using namespace nvcuda;
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
// Starts and ends with the group synchronised.
template <typename T, int TM, bool TRANS, int NT = THREADS, int BAR = 0>
__device__ void layer_mm(const Operand<T>* ops, int n_ops, int nout, T* wbuf,
                         float* C) {
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
  if constexpr (is_bf16<T>()) {
    constexpr int FR = TM / 16, WARPS = NT / 32, NF = HID / WARPS / 16;
    const int warp = tid / 32;
    const int wcols = nout / WARPS, nfc = wcols / 16, col0 = warp * wcols;
    typedef typename std::conditional<TRANS, wmma::col_major,
                                      wmma::row_major>::type BLayout;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FR][NF];
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
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
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16_t, wmma::row_major>
            fa[FR];
#pragma unroll
        for (int i = 0; i < FR; ++i)
          wmma::load_matrix_sync(fa[i], op->a + i * 16 * op->lda + k0 + kk,
                                 op->lda);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          if (j < nfc) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, BLayout> fb;
            if constexpr (TRANS)
              wmma::load_matrix_sync(
                  fb, wb + (col0 + j * 16) * (KS + pad16<T>()) + kk,
                  KS + pad16<T>());
            else
              wmma::load_matrix_sync(
                  fb, wb + kk * (nout + pad16<T>()) + col0 + j * 16,
                  nout + pad16<T>());
#pragma unroll
            for (int i = 0; i < FR; ++i)
              wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
          }
        }
      }
      group_sync<NT, BAR>();
    }
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
        if (j < nfc)
          wmma::store_matrix_sync(C + i * 16 * CLD + col0 + j * 16,
                                  acc[i][j], CLD, wmma::mem_row_major);
  } else {
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
  }
  group_sync<NT, BAR>();
}

// ---------------------------------------------------------------------------
// Split-K dW = act^T delta (db = 1^T delta) and the fixed-order sum of splits
// ---------------------------------------------------------------------------

constexpr int MAX_TASKS = 32;
struct Tasks {
  int n;
  int v[MAX_TASKS][5];  // act col (-1: ones), M, delta col, N, out offset
  int tile_start[MAX_TASKS + 1];
};
constexpr int TT = 64;         // output tile edge
constexpr int PK = 32;         // points per chunk
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

template <typename T>
constexpr size_t dw_smem() {
  return 2 * 2 * (size_t)PK * (TT + pad16<T>()) * sizeof(T)
         + (size_t)TT * TT * 4;
}

// grid (tiles of all tasks, splits): each CTA owns one 64x64 output tile and
// the fixed point range of its split (cps chunks of PK points, the last
// split's possibly fewer or none), and writes an fp32 partial
// (partials[split][total]).  acts/deltas are row-major with row strides
// act_ld/delta_ld; n_pts is a multiple of PK.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
dw_splitk_kernel(const T* __restrict__ acts, int act_ld,
                 const T* __restrict__ deltas, int delta_ld,
                 float* __restrict__ partials, int n_pts, int cps, int total,
                 Tasks tk) {
  constexpr int LD = TT + pad16<T>(), V = pad16<T>(), CPR = TT / V;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);     // [2][PK][LD]
  T* Ds = As + 2 * PK * LD;               // [2][PK][LD]
  float* Cs = reinterpret_cast<float*>(Ds + 2 * PK * LD);  // [TT][TT]

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
      As[i] = from_f<T>((i % LD) == 0 ? 1.f : 0.f);
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

  if constexpr (is_bf16<T>()) {
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    if (c_lo < c_hi) load(c_lo, 0);
    for (int c = c_lo; c < c_hi; ++c) {
      const int b = (c - c_lo) & 1;
      if (c + 1 < c_hi) { load(c + 1, b ^ 1); cp_wait<1>(); }
      else { cp_wait<0>(); }
      __syncthreads();
      const T* A = As + b * PK * LD;
      const T* D = Ds + b * PK * LD;
#pragma unroll
      for (int kk = 0; kk < PK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16_t, wmma::col_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, wmma::row_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], A + kk * LD + wm + i * 16, LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], D + kk * LD + wn + j * 16, LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + i * 16) * TT + wn + j * 16,
                                acc[i][j], TT, wmma::mem_row_major);
  } else {
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
      const T* A = As + b * PK * LD;
      const T* D = Ds + b * PK * LD;
      for (int p = 0; p < PK; ++p) {
        const float d = to_f(D[p * LD + n]);
#pragma unroll
        for (int m = 0; m < 32; ++m) acc[m] += to_f(A[p * LD + mb + m]) * d;
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 32; ++m) Cs[(mb + m) * TT + n] = acc[m];
  }
  __syncthreads();
  float* dst = partials + (size_t)blockIdx.y * (size_t)total + off;
  for (int i = threadIdx.x; i < TT * TT; i += DW_THREADS) {
    const int m = i / TT, n = i % TT;
    if (m0 + m < M && n0 + n < N) dst[(m0 + m) * N + n0 + n] = Cs[i];
  }
}

// dw[i] = (accumulate ? dw[i] : 0) + sum over splits, in split order.
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
  auto kw = dw_splitk_kernel<T>;
  constexpr size_t smw = dw_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(
      kw, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smw);
  if (e != cudaSuccess) return e;
  kw<<<dim3(tk.tile_start[tk.n], splits), DW_THREADS, smw, st>>>(
      acts, act_ld, deltas, delta_ld, partials, n_pts, cps, total, tk);
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
