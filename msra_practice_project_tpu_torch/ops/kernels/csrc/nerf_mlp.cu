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
//    Two launches on the same inputs give bitwise-equal gradients.  (b) and
//    (c) are tile_mm.cuh's dw_splitk, shared with film_mlp.cu.
//
// bf16 = 0 is the fp32 check mode (fp32 operands, FMA on the CUDA cores).
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "tile_mm.cuh"

namespace {

using namespace tile_mm;

constexpr int IN_PAD = 8, PE_POS = 64, PE_DIR = 32, RGB_HID = 128;
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
  return (int)dw_splitk<T>(reinterpret_cast<const T*>(acts), ACT_PAD,
                           reinterpret_cast<const T*>(deltas), DELTA_W,
                           partials, dw, n, splits, tk, total, 0, st);
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
  const int total = make_tasks(tasks, n_tasks, tk);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? bwd_launch<bf16_t, 64>(P, dy, acts, deltas, partials, dw, n,
                                       splits, tk, total, st)
              : bwd_launch<float, 32>(P, dy, acts, deltas, partials, dw, n,
                                      splits, tk, total, st);
}
