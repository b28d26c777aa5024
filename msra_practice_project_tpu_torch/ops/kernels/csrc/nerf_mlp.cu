// Fused NeRF MLP kernels for Hopper (sm_90a): the NeRF train step's forward
// with saved activations (K1) and its backward from them (K2, no input grad).
//
// K1 `nerf_mlp_fwd_save` replaces msra_practice_project_tpu/ops/pallas/
//    nerf_mlp.py::_fwd_save_kernel (launched by _fused_forward_save).
//    Bound on an H100: per point it reads 32 B of input and writes 5,120 B of
//    bf16 activations + 32 B of output, and does 591,488 MACs (unpadded
//    layers; chip_smoke.py's mlp_macs counts them).  At the
//    train step's 65,536 / 196,608 points that is ~0.10 / ~0.30 ms of HBM
//    traffic at 3.35 TB/s against ~0.08 / ~0.24 ms of bf16 tensor-core work
//    at 989 TFLOP/s: memory-bound.  Design: one CTA per tile of 64 points
//    (32 in the fp32 check mode) keeps the tile's activations in shared
//    memory (bf16, ping-pong between two [64, 256] buffers), streams each
//    layer's weights through shared memory in 32-row slices (cp.async double
//    buffer, the weights stay L2-resident across CTAs), runs the matmuls on
//    the tensor cores (WMMA bf16, fp32 accumulate) and writes each
//    activation to the spill once, from the epilogue.  The skip and view-dir
//    concats are two products into one accumulator.  The PE is computed
//    directly with accurate sinf/cosf (no fast math: its arguments reach
//    ~3,000 rad).
//
// K2 `nerf_mlp_bwd_saved` replaces _bwd_saved_kernel + _grad_body
//    (need_dx=False; launched by _fused_backward_saved).  Bound on an H100:
//    1,149,824 MACs per point (the delta chain plus dW = act^T delta), reading
//    5,120 B of activations: ~0.15 / ~0.46 ms at 989 TFLOP/s bf16,
//    compute-bound.  The TPU sums dW over its sequential grid in VMEM; a
//    Hopper CTA cannot hold 2.4 MB of fp32 partial dW and float atomics would
//    make gradients differ from run to run.  Design, three deterministic
//    passes:
//      (a) per tile of points: rebuild the sigma/rgb heads from the saved
//          h7/h9, run the dh = (delta W^T) * relu_mask chain on the tensor
//          cores and write every layer's delta (bf16) to a workspace;
//      (b) split-K dW = act^T delta (and db = 1^T delta) over 64x64 output
//          tiles of the 26 parameters; each split owns a fixed range of
//          points and writes an fp32 partial;
//      (c) a fixed-order sum of the partials.
//    Two launches on the same inputs give bitwise-equal gradients.
//
// bf16 = 0 is the fp32 check mode (fp32 operands, FMA on the CUDA cores).
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16_t;

namespace {

constexpr int IN_PAD = 8, PE_POS = 64, PE_DIR = 32, HID = 256, RGB_HID = 128;
constexpr int OUT_PAD = 8, ACT_PAD = 2560, DELTA_W = 2448;
// ACT_SLOTS columns of the activation spill
constexpr int A_H0 = 96, A_HD = A_H0 + 8 * HID, A_H9 = A_HD + HID;
constexpr int ACT_W = A_H9 + RGB_HID;  // 2528
// DELTA_SLOTS columns of K2's delta workspace: dr, dsig, dh9, dhd, dh7..dh0
constexpr int D_DH9 = 16, D_DHD = 144, D_DH7 = 400;
// packed parameters, in PACK_KEYS order
enum {
  W0, B0, W1, B1, W2, B2, W3, B3, W4, B4, W5A, W5B, B5, W6, B6, W7, B7,
  W8, B8, W9A, W9B, B9, WS, BS, WR, BR, N_PARAMS
};
struct Params { const void* p[N_PARAMS]; };

constexpr int THREADS = 256;
constexpr int KS = 32;  // weight rows per shared-memory slice

template <typename T> __host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16_t>::value;
}
template <typename T> __host__ __device__ constexpr int pad16() {
  return 16 / (int)sizeof(T);
}
// a weight slice, either layout: [KS][HID + pad] or [HID][KS + pad]
template <typename T> __host__ __device__ constexpr int wstage() {
  return KS * (HID + pad16<T>()) > HID * (KS + pad16<T>())
             ? KS * (HID + pad16<T>()) : HID * (KS + pad16<T>());
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

// One product of a layer: A [TM, k] in shared memory (row stride lda) times
// W [k, nout] (row-major in global memory), or, with TRANS, times W^T where
// W is [nout, k] row-major.
template <typename T> struct Operand {
  const T* a;
  int lda;
  int k;
  const T* w;
};

template <typename T, bool TRANS>
__device__ __forceinline__ void load_slice(const Operand<T>& op, int k0,
                                           int nout, T* wb) {
  constexpr int V = pad16<T>();
  if (!TRANS) {
    const int ldw = nout + pad16<T>(), cpr = nout / V;
    for (int c = threadIdx.x; c < KS * cpr; c += THREADS) {
      const int r = c / cpr, col = (c % cpr) * V;
      cp16(wb + r * ldw + col, op.w + (size_t)(k0 + r) * nout + col);
    }
  } else {
    constexpr int ldw = KS + pad16<T>(), cpr = KS / V;
    for (int c = threadIdx.x; c < nout * cpr; c += THREADS) {
      const int n = c / cpr, col = (c % cpr) * V;
      cp16(wb + n * ldw + col, op.w + (size_t)n * op.k + k0 + col);
    }
  }
}

// C[TM, nout] (fp32, row stride CLD) = sum over ops of A @ W (or A @ W^T).
// nout is 256 or 128.  Starts and ends with the block synchronised.
template <typename T, int TM, bool TRANS>
__device__ void layer_mm(const Operand<T>* ops, int n_ops, int nout, T* wbuf,
                         float* C) {
  const int n0 = ops[0].k / KS;
  const int S = n0 + (n_ops > 1 ? ops[1].k / KS : 0);
  auto slice = [&](int s, const Operand<T>*& op, int& k0) {
    if (s < n0) { op = &ops[0]; k0 = s * KS; }
    else { op = &ops[1]; k0 = (s - n0) * KS; }
  };
  constexpr int STAGE = wstage<T>();
  {
    const Operand<T>* op; int k0;
    slice(0, op, k0);
    load_slice<T, TRANS>(*op, k0, nout, wbuf);
    cp_commit();
  }
  if constexpr (is_bf16<T>()) {
    constexpr int FR = TM / 16;
    const int warp = threadIdx.x / 32;
    const int wcols = nout / 8, nfc = wcols / 16, col0 = warp * wcols;
    typedef typename std::conditional<TRANS, wmma::col_major,
                                      wmma::row_major>::type BLayout;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FR][2];
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int s = 0; s < S; ++s) {
      if (s + 1 < S) {
        const Operand<T>* op; int k0;
        slice(s + 1, op, k0);
        load_slice<T, TRANS>(*op, k0, nout, wbuf + ((s + 1) & 1) * STAGE);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
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
        for (int j = 0; j < 2; ++j) {
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
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nfc)
          wmma::store_matrix_sync(C + i * 16 * CLD + col0 + j * 16,
                                  acc[i][j], CLD, wmma::mem_row_major);
  } else {
    // fp32 check mode: one output column per thread, TM/(256/nout) rows
    const int rows = TM / (THREADS / nout);
    const int col = threadIdx.x % nout, r0 = (threadIdx.x / nout) * rows;
    float acc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = 0.f;
    for (int s = 0; s < S; ++s) {
      if (s + 1 < S) {
        const Operand<T>* op; int k0;
        slice(s + 1, op, k0);
        load_slice<T, TRANS>(*op, k0, nout, wbuf + ((s + 1) & 1) * STAGE);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const T* wb = wbuf + (s & 1) * STAGE;
      const Operand<T>* op; int k0;
      slice(s, op, k0);
      for (int k = 0; k < KS; ++k) {
        const float w = TRANS ? to_f(wb[col * (KS + pad16<T>()) + k])
                              : to_f(wb[k * (nout + pad16<T>()) + col]);
        const T* a = op->a + r0 * op->lda + k0 + k;
#pragma unroll
        for (int r = 0; r < TM; ++r)
          if (r < rows) acc[r] += to_f(a[r * op->lda]) * w;
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
      if (r < rows) C[(r0 + r) * CLD + col] = acc[r];
  }
  __syncthreads();
}

// Forward epilogue: v = C + b (relu or linear) -> T into the tile buffer
// (row stride lda) and into the activation spill (row stride ACT_PAD).
template <typename T, int TM>
__device__ void epilogue_fwd(const float* C, const float* bias, int nout,
                             bool relu, T* dst, int lda, T* spill) {
  constexpr int V = pad16<T>();
  const int cpr = nout / V;
  for (int c = threadIdx.x; c < TM * cpr; c += THREADS) {
    const int r = c / cpr, col = (c % cpr) * V;
    alignas(16) T v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float x = C[r * CLD + col + i] + bias[col + i];
      v[i] = from_f<T>(relu ? fmaxf(x, 0.f) : x);
    }
    *reinterpret_cast<uint4*>(dst + r * lda + col) =
        *reinterpret_cast<const uint4*>(v);
    *reinterpret_cast<uint4*>(spill + (size_t)r * ACT_PAD + col) =
        *reinterpret_cast<const uint4*>(v);
  }
  __syncthreads();
}

template <typename T, int TM>
constexpr size_t fwd_smem() {
  return (size_t)TM * CLD * 4 + 2 * (size_t)TM * (HID + pad16<T>()) * sizeof(T)
         + (size_t)TM * (PE_POS + pad16<T>()) * sizeof(T)
         + (size_t)TM * (PE_DIR + pad16<T>()) * sizeof(T)
         + 2 * (size_t)wstage<T>() * sizeof(T) + (size_t)TM * IN_PAD * 4
         + (size_t)TM * 4;
}

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS, 1)
fwd_save_kernel(const float* __restrict__ x, Params P,
                float* __restrict__ out, T* __restrict__ acts) {
  constexpr int LDA = HID + pad16<T>(), LDP = PE_POS + pad16<T>(),
                LDD = PE_DIR + pad16<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* C = reinterpret_cast<float*>(smem);
  T* cur = reinterpret_cast<T*>(C + TM * CLD);
  T* nxt = cur + TM * LDA;
  T* pe_p = nxt + TM * LDA;
  T* pe_d = pe_p + TM * LDP;
  T* wbuf = pe_d + TM * LDD;
  float* xs = reinterpret_cast<float*>(wbuf + 2 * wstage<T>());
  float* sig = xs + TM * IN_PAD;

  const int row0 = blockIdx.x * TM;
  T* spill = acts + (size_t)row0 * ACT_PAD;
  auto W = [&](int i) { return reinterpret_cast<const T*>(P.p[i]); };
  auto Bv = [&](int i) { return reinterpret_cast<const float*>(P.p[i]); };

  for (int i = threadIdx.x; i < TM * IN_PAD; i += THREADS)
    xs[i] = x[(size_t)row0 * IN_PAD + i];
  __syncthreads();

  // Positional encodings, interleaved [sin_f(3), cos_f(3)] per frequency f,
  // zero-padded: pe_p (10 freqs of pos) at spill cols 0..63, pe_d (4 of dir)
  // at 64..95.  Spill pad cols 2528..2559 are zeroed.
  for (int i = threadIdx.x; i < TM * (PE_POS + PE_DIR); i += THREADS) {
    const int r = i / (PE_POS + PE_DIR), j = i % (PE_POS + PE_DIR);
    const bool pos = j < PE_POS;
    const int jj = pos ? j : j - PE_POS;
    float v = 0.f;
    if (jj < 6 * (pos ? 10 : 4)) {
      const int f = jj / 6, rem = jj % 6, d = rem % 3 + (pos ? 0 : 3);
      const float a = xs[r * IN_PAD + d] * (float)(1 << f);
      v = rem < 3 ? sinf(a) : cosf(a);
    }
    const T tv = from_f<T>(v);
    if (pos) pe_p[r * LDP + jj] = tv; else pe_d[r * LDD + jj] = tv;
    spill[(size_t)r * ACT_PAD + j] = tv;
  }
  for (int i = threadIdx.x; i < TM * (ACT_PAD - ACT_W); i += THREADS) {
    const int r = i / (ACT_PAD - ACT_W), j = i % (ACT_PAD - ACT_W);
    spill[(size_t)r * ACT_PAD + ACT_W + j] = from_f<T>(0.f);
  }
  __syncthreads();

  Operand<T> o[2];
  o[0] = {pe_p, LDP, PE_POS, W(W0)};
  layer_mm<T, TM, false>(o, 1, HID, wbuf, C);
  epilogue_fwd<T, TM>(C, Bv(B0), HID, true, cur, LDA, spill + A_H0);
  for (int l = 1; l <= 7; ++l) {  // h1..h7; h5 adds the skip product
    if (l == 5) {
      o[0] = {pe_p, LDP, PE_POS, W(W5A)};
      o[1] = {cur, LDA, HID, W(W5B)};
      layer_mm<T, TM, false>(o, 2, HID, wbuf, C);
    } else {
      const int wi = l < 5 ? W0 + 2 * l : (l == 6 ? W6 : W7);
      o[0] = {cur, LDA, HID, W(wi)};
      layer_mm<T, TM, false>(o, 1, HID, wbuf, C);
    }
    const int bi = l < 5 ? B0 + 2 * l : (l == 5 ? B5 : (l == 6 ? B6 : B7));
    epilogue_fwd<T, TM>(C, Bv(bi), HID, true, nxt, LDA,
                        spill + A_H0 + l * HID);
    T* tmp = cur; cur = nxt; nxt = tmp;
  }
  // sigma head from h7 (cur), before its buffer is reused
  {
    const T* ws = W(WS);
    for (int r = threadIdx.x; r < TM; r += THREADS) {
      float s = 0.f;
      for (int k = 0; k < HID; ++k)
        s += to_f(cur[r * LDA + k]) * to_f(ws[k * OUT_PAD]);
      sig[r] = fmaxf(s + Bv(BS)[0], 0.f);
    }
  }
  // hd = h7 @ W8 + b8 (linear)
  o[0] = {cur, LDA, HID, W(W8)};
  layer_mm<T, TM, false>(o, 1, HID, wbuf, C);
  epilogue_fwd<T, TM>(C, Bv(B8), HID, false, nxt, LDA, spill + A_HD);
  // h9 = relu(hd @ W9a + pe_d @ W9b + b9), 128 wide, into h7's buffer
  o[0] = {nxt, LDA, HID, W(W9A)};
  o[1] = {pe_d, LDD, PE_DIR, W(W9B)};
  layer_mm<T, TM, false>(o, 2, RGB_HID, wbuf, C);
  epilogue_fwd<T, TM>(C, Bv(B9), RGB_HID, true, cur, LDA, spill + A_H9);
  // rgb head and the output row [rgb(3), sigma, 0, 0, 0, 0]
  {
    const T* wr = W(WR);
    const float* br = Bv(BR);
    for (int i = threadIdx.x; i < TM * OUT_PAD; i += THREADS) {
      const int r = i / OUT_PAD, c = i % OUT_PAD;
      float v = 0.f;
      if (c < 3) {
        float s = 0.f;
        for (int k = 0; k < RGB_HID; ++k)
          s += to_f(cur[r * LDA + k]) * to_f(wr[k * OUT_PAD + c]);
        v = 1.f / (1.f + expf(-(s + br[c])));
      } else if (c == 3) {
        v = sig[r];
      }
      out[(size_t)(row0 + r) * OUT_PAD + c] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// K2 (a): per-tile delta chain
// ---------------------------------------------------------------------------

// Backward epilogue: d = (C [+ dsig * Ws[:, 0]]) * (act > 0) -> T into the
// tile buffer and the delta workspace.
template <typename T, int TM>
__device__ void epilogue_bwd(const float* C, const T* act, const float* dsig,
                             const T* ws, T* dst, int lda, T* dl) {
  constexpr int V = pad16<T>();
  constexpr int cpr = HID / V;
  for (int c = threadIdx.x; c < TM * cpr; c += THREADS) {
    const int r = c / cpr, col = (c % cpr) * V;
    alignas(16) T v[V];
    alignas(16) T m[V];
    if (act)
      *reinterpret_cast<uint4*>(m) =
          *reinterpret_cast<const uint4*>(act + (size_t)r * ACT_PAD + col);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float x = C[r * CLD + col + i];
      if (dsig) x += dsig[r * 16] * to_f(ws[(col + i) * OUT_PAD]);
      if (act && !(to_f(m[i]) > 0.f)) x = 0.f;
      v[i] = from_f<T>(x);
    }
    *reinterpret_cast<uint4*>(dst + r * lda + col) =
        *reinterpret_cast<const uint4*>(v);
    *reinterpret_cast<uint4*>(dl + (size_t)r * DELTA_W + col) =
        *reinterpret_cast<const uint4*>(v);
  }
  __syncthreads();
}

template <typename T, int TM>
constexpr size_t delta_smem() {
  return (size_t)TM * CLD * 4 + 2 * (size_t)TM * (HID + pad16<T>()) * sizeof(T)
         + 2 * (size_t)wstage<T>() * sizeof(T) + (size_t)TM * 16 * 4;
}

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS, 1)
bwd_delta_kernel(Params P, const float* __restrict__ dy,
                 const T* __restrict__ acts, T* __restrict__ deltas) {
  constexpr int LDA = HID + pad16<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* C = reinterpret_cast<float*>(smem);
  T* cur = reinterpret_cast<T*>(C + TM * CLD);
  T* nxt = cur + TM * LDA;
  T* wbuf = nxt + TM * LDA;
  float* small = reinterpret_cast<float*>(wbuf + 2 * wstage<T>());

  const int row0 = blockIdx.x * TM;
  const T* act = acts + (size_t)row0 * ACT_PAD;
  T* dl = deltas + (size_t)row0 * DELTA_W;
  auto W = [&](int i) { return reinterpret_cast<const T*>(P.p[i]); };
  auto Bv = [&](int i) { return reinterpret_cast<const float*>(P.p[i]); };

  // Heads rebuilt from the saved h7/h9; the 16 small delta columns are
  // dr = dy_rgb * rgb * (1 - rgb) (cols 0..2) and dsig = dy_sigma * (sigma
  // > 0) (col 8), zeros elsewhere.  `small` keeps them as stored (rounded).
  for (int i = threadIdx.x; i < TM * 16; i += THREADS) {
    const int r = i / 16, c = i % 16;
    float v = 0.f;
    if (c < 3) {
      float s = 0.f;
      for (int k = 0; k < RGB_HID; ++k)
        s += to_f(act[(size_t)r * ACT_PAD + A_H9 + k])
             * to_f(W(WR)[k * OUT_PAD + c]);
      const float rgb = 1.f / (1.f + expf(-(s + Bv(BR)[c])));
      v = dy[(size_t)(row0 + r) * OUT_PAD + c] * rgb * (1.f - rgb);
    } else if (c == 8) {
      float s = 0.f;
      for (int k = 0; k < HID; ++k)
        s += to_f(act[(size_t)r * ACT_PAD + A_H0 + 7 * HID + k])
             * to_f(W(WS)[k * OUT_PAD]);
      const float sg = fmaxf(s + Bv(BS)[0], 0.f);
      v = sg > 0.f ? dy[(size_t)(row0 + r) * OUT_PAD + 3] : 0.f;
    }
    const T tv = from_f<T>(v);
    dl[(size_t)r * DELTA_W + c] = tv;
    small[i] = to_f(tv);
  }
  __syncthreads();
  // dh9 = (dr @ Wr^T) * (h9 > 0)
  for (int i = threadIdx.x; i < TM * RGB_HID; i += THREADS) {
    const int r = i / RGB_HID, j = i % RGB_HID;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s += small[r * 16 + c] * to_f(W(WR)[j * OUT_PAD + c]);
    const bool on = to_f(act[(size_t)r * ACT_PAD + A_H9 + j]) > 0.f;
    const T tv = from_f<T>(on ? s : 0.f);
    cur[r * LDA + j] = tv;
    dl[(size_t)r * DELTA_W + D_DH9 + j] = tv;
  }
  __syncthreads();

  Operand<T> o;
  // dhd = dh9 @ W9a^T (hd is linear: no mask)
  o = {cur, LDA, RGB_HID, W(W9A)};
  layer_mm<T, TM, true>(&o, 1, HID, wbuf, C);
  epilogue_bwd<T, TM>(C, nullptr, nullptr, nullptr, nxt, LDA, dl + D_DHD);
  // dh7 = (dsig Ws^T + dhd W8^T) * (h7 > 0)
  o = {nxt, LDA, HID, W(W8)};
  layer_mm<T, TM, true>(&o, 1, HID, wbuf, C);
  epilogue_bwd<T, TM>(C, act + A_H0 + 7 * HID, small + 8, W(WS), cur, LDA,
                      dl + D_DH7);
  // dh_{l-1} = (dh_l W_l^T) * (h_{l-1} > 0), l = 7..1 (W5b for l = 5)
  for (int l = 7; l >= 1; --l) {
    const int wi = l < 5 ? W0 + 2 * l : (l == 5 ? W5B : (l == 6 ? W6 : W7));
    o = {cur, LDA, HID, W(wi)};
    layer_mm<T, TM, true>(&o, 1, HID, wbuf, C);
    epilogue_bwd<T, TM>(C, act + A_H0 + (l - 1) * HID, nullptr, nullptr, nxt,
                        LDA, dl + D_DH7 + (8 - l) * HID);
    T* tmp = cur; cur = nxt; nxt = tmp;
  }
}

// ---------------------------------------------------------------------------
// K2 (b): split-K dW = act^T delta, db = 1^T delta;  (c): fixed-order sum
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

template <typename T>
constexpr size_t dw_smem() {
  return 2 * 2 * (size_t)PK * (TT + pad16<T>()) * sizeof(T)
         + (size_t)TT * TT * 4;
}

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
bwd_dw_kernel(const T* __restrict__ acts, const T* __restrict__ deltas,
              float* __restrict__ partials, int n_pts, int total, Tasks tk) {
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
  const int cps = (n_chunks + gridDim.y - 1) / gridDim.y;
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
                   acts + pt * ACT_PAD + a0 + m0 + col, m0 + col < M);
      cp16_zfill(Ds + (b * PK + p) * LD + col,
                 deltas + pt * DELTA_W + d0 + n0 + col, n0 + col < N);
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

__global__ void sum_splits_kernel(const float* __restrict__ partials,
                                  float* __restrict__ dw, int total,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partials[(size_t)k * total + i];
  dw[i] = s;
}

template <typename T, int TM>
int fwd_launch(const float* x, const Params& P, float* out, void* acts,
               int n, cudaStream_t st) {
  auto kern = fwd_save_kernel<T, TM>;
  constexpr size_t sm = fwd_smem<T, TM>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (e != cudaSuccess) return (int)e;
  kern<<<n / TM, THREADS, sm, st>>>(x, P, out, reinterpret_cast<T*>(acts));
  return (int)cudaGetLastError();
}

template <typename T, int TM>
int bwd_launch(const Params& P, const float* dy, const void* acts,
               void* deltas, float* partials, float* dw, int n, int splits,
               const Tasks& tk, int total, cudaStream_t st) {
  auto kd = bwd_delta_kernel<T, TM>;
  constexpr size_t smd = delta_smem<T, TM>();
  cudaError_t e = cudaFuncSetAttribute(
      kd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smd);
  if (e != cudaSuccess) return (int)e;
  kd<<<n / TM, THREADS, smd, st>>>(P, dy, reinterpret_cast<const T*>(acts),
                                   reinterpret_cast<T*>(deltas));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kw = bwd_dw_kernel<T>;
  constexpr size_t smw = dw_smem<T>();
  e = cudaFuncSetAttribute(kw, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smw);
  if (e != cudaSuccess) return (int)e;
  kw<<<dim3(tk.tile_start[tk.n], splits), DW_THREADS, smw, st>>>(
      reinterpret_cast<const T*>(acts), reinterpret_cast<const T*>(deltas),
      partials, n, total, tk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_splits_kernel<<<(total + 255) / 256, 256, 0, st>>>(partials, dw, total,
                                                         splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nerf_mlp_fwd_save(const float* x, const void* const* w,
                                 float* out, void* acts, int n, int bf16,
                                 void* stream) {
  Params P;
  for (int i = 0; i < N_PARAMS; ++i) P.p[i] = w[i];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n % 128) return (int)cudaErrorInvalidValue;
  return bf16 ? fwd_launch<bf16_t, 64>(x, P, out, acts, n, st)
              : fwd_launch<float, 32>(x, P, out, acts, n, st);
}

extern "C" int nerf_mlp_bwd_saved(const void* const* w, const float* dy,
                                  const void* acts, void* deltas,
                                  float* partials, float* dw, int n,
                                  int splits, const int* tasks, int n_tasks,
                                  int bf16, void* stream) {
  if (n % 128 || n_tasks > MAX_TASKS || splits < 1)
    return (int)cudaErrorInvalidValue;
  Params P;
  for (int i = 0; i < N_PARAMS; ++i) P.p[i] = w[i];
  Tasks tk;
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? bwd_launch<bf16_t, 64>(P, dy, acts, deltas, partials, dw, n,
                                       splits, tk, total, st)
              : bwd_launch<float, 32>(P, dy, acts, deltas, partials, dw, n,
                                      splits, tk, total, st);
}
