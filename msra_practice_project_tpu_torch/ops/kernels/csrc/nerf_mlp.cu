// Fused NeRF MLP kernels for Hopper (sm_90a): every Pallas kernel of
// msra_practice_project_tpu/ops/pallas/nerf_mlp.py.  Per point (unpadded
// layers; ops/kernels/nerf_mlp.py::macs_per_point counts them) the forward
// does 591,488
// MACs, K2's delta chain and dW 1,149,824, the input gradient 33,792.
//
// K1 `nerf_mlp_fwd_save` replaces _fwd_save_kernel (launched by
//    _fused_forward_save).  Bound on an H100: per point it reads 32 B of
//    input and writes 5,120 B of bf16 activations + 32 B of output: at the
//    train step's 65,536 / 196,608 points that is ~0.10 / ~0.30 ms of HBM
//    traffic at 3.35 TB/s against ~0.08 / ~0.24 ms of bf16 tensor-core work
//    at 989 TFLOP/s: memory-bound.  bf16: nerf_fwd_tc_kernel<true> (section
//    "bf16: the forward and the delta chain on wgmma"): two 64-point tiles
//    per CTA on one TMA weight stream, wgmma, register epilogues, each
//    activation from shared memory to the spill by TMA.  The PE is computed
//    directly with accurate sinf/cosf (no fast math: its arguments reach
//    ~3,000 rad).
//
// K3 `nerf_mlp_fwd` replaces _fwd_kernel (launched by _fused_forward with
//    pipe=False): K1's kernel without the spill writes, so its output is
//    bitwise equal to K1's.  Bound: 64 B of I/O per point against the
//    forward's MACs, ~0.078 / ~0.235 / ~0.314 ms at 65,536 / 196,608 /
//    262,144 points: bound by operations.
//
// K6 `nerf_mlp_fwd` with pipe = 1 replaces _fwd_kernel_pipelined (two
//    half-tile chains whose stages the TPU interleaves in program order, so
//    its VLIW bundles co-issue one chain's epilogue under the other's
//    matmuls).  bf16: K3's kernel, whose two warpgroups (one tile each, on
//    one weight stream) are those two chains, so K6 is K3, bitwise.
//
// K2 `nerf_mlp_bwd_saved` replaces _bwd_saved_kernel + _grad_body
//    (launched by _fused_backward_saved).  Bound on an H100: the delta chain
//    plus dW = act^T delta, reading 5,120 B of activations per point: ~0.15
//    / ~0.46 ms at 989 TFLOP/s bf16, compute-bound.  The TPU sums dW over its
//    sequential grid in VMEM; a Hopper CTA cannot hold 2.4 MB of fp32
//    partial dW and float atomics would make gradients differ from run to
//    run.  Design, three deterministic passes:
//      (a) per tile of points: rebuild the sigma/rgb heads from the saved
//          h7/h9, run the dh = (delta W^T) * relu_mask chain on the tensor
//          cores and write every layer's delta (bf16) to a workspace
//          (`nerf_mlp_deltas` alone; bf16: nerf_bwd_delta_tc_kernel, ~0.18 /
//          ~0.54 ms of bytes at 65,536 / 196,608 points);
//      (b) split-K dW = act^T delta (and db = 1^T delta) of the 26
//          parameters (tile_mm.cuh: TMA ring, wgmma, CTAs of up to 128 x
//          256 outputs, db folded into the weight task that reads the same
//          deltas); each split owns a fixed range of points and writes an
//          fp32 partial;
//      (c) a fixed-order sum of the partials.
//    Two launches on the same inputs give bitwise-equal gradients.  (b) and
//    (c) are tile_mm.cuh's split-K pass, shared with film_mlp.cu.
//
// K5 `nerf_mlp_bwd` replaces _bwd_kernel + _grad_body (launched by
//    _fused_backward): the backward that recomputes the forward.  Bound:
//    1,741,312 MACs per point, ~0.23 / ~0.69 ms at 65,536 / 196,608 points,
//    by operations.  A tile's ten activations do not fit in shared memory,
//    so per chunk of points K1's forward kernel writes them to a workspace
//    and K2's delta kernel runs the chain from it (deltas to a workspace;
//    fp32: one kernel per tile, bwd_recompute_kernel, does both); then K2's
//    split-K pass covers the chunk.  Chunks hold whole splits of K2's
//    split-K over all the points (the wrapper bounds them to 2 GiB of
//    workspace), and one fixed-order sum closes: dW/db are bitwise equal to
//    K1 -> K2's on the same inputs, whatever the chunking.  When asked, the
//    deltas K4 reads (dh9, dh5, dh0) also go to a copy of their own.
//
// K4 `nerf_mlp_dx` replaces _grad_body's need_dx block: dx from the stored
//    deltas of the layers that read the PEs (K2's workspace or K5's copy):
//    dpe_p = dh5 W5a^T + dh0 W0^T and dpe_d = dh9 W9b^T with fp32
//    accumulation, then the chain rule through the direct PE, dx_d += 2^f
//    (dpe[sin_f, d] cos(2^f x_d) - dpe[cos_f, d] sin(2^f x_d)), with accurate
//    sinf/cosf (the 2^9 factor amplifies any error in the last bits).
//    Bound: 1,344 B per point read or written, ~0.026 / ~0.079 / ~0.105
//    ms at 65,536 / 196,608 / 262,144 points: by bytes (its 33,792 MACs
//    per point take ~4.5 us on the tensor cores, but ~0.066 ms as FMA on
//    the CUDA cores at 65,536 points).  bf16: dx_tc_kernel (section "bf16:
//    K4 on wgmma"): a persistent grid of 128-point tiles; the PE weights
//    resident in shared memory as K-major B operands, the deltas streamed
//    by TMA through a ring, the products on wgmma, the chain rule on the
//    CUDA cores from the accumulators staged in shared memory.
//
// bf16 = 0 is the fp32 check mode (fp32 operands, FMA on the CUDA cores:
// fwd_kernel, fwd_pipelined_kernel, bwd_delta_kernel, bwd_recompute_kernel,
// one CTA per tile of 32 or 16 points, tile_mm.cuh's layer_mm).  Every
// launch goes on the caller's stream, allocates nothing and returns the
// first CUDA error.

#include "tile_mm.cuh"

namespace {

using namespace tile_mm;

constexpr int IN_PAD = 8, PE_POS = 64, PE_DIR = 32, RGB_HID = 128;
constexpr int OUT_PAD = 8, ACT_PAD = 2560, DELTA_W = 2448;
// ACT_SLOTS columns of the activation spill
constexpr int A_H0 = 96, A_HD = A_H0 + 8 * HID, A_H9 = A_HD + HID;
constexpr int ACT_W = A_H9 + RGB_HID;  // 2528
// DELTA_SLOTS columns of the delta workspace: dr, dsig, dh9, dhd, dh7..dh0
constexpr int D_DH9 = 16, D_DHD = 144, D_DH7 = 400;
constexpr int D_DH5 = D_DH7 + 2 * HID, D_DH0 = D_DH7 + 7 * HID;
// K5's copy of the deltas K4 reads, one row per point: dh9 | dh5 | dh0
constexpr int PE_DW = RGB_HID + 2 * HID;  // 640
// packed parameters, in PACK_KEYS order
enum {
  W0, B0, W1, B1, W2, B2, W3, B3, W4, B4, W5A, W5B, B5, W6, B6, W7, B7,
  W8, B8, W9A, W9B, B9, WS, BS, WR, BR, N_PARAMS
};
struct Params { const void* p[N_PARAMS]; };

template <typename T> __host__ __device__ constexpr int lda() {
  return HID + pad16<T>();
}
template <typename T> __host__ __device__ constexpr int ldp() {
  return PE_POS + pad16<T>();
}
template <typename T> __host__ __device__ constexpr int ldd() {
  return PE_DIR + pad16<T>();
}

// ---------------------------------------------------------------------------
// fp32: the forward (K1, K3, K5's recompute, K6's two halves)
// ---------------------------------------------------------------------------

// One group's view of the forward's shared buffers: its rows of C, of the
// two activation buffers, of the PEs, of x and of sigma, and its own weight
// double buffer.
template <typename T> struct FwdSmem {
  float* C;
  T *cur, *nxt, *pe_p, *pe_d, *wbuf;
  float *xs, *sig;
};

// Shared memory of the forward for a CTA of TM rows whose NG groups each
// have a weight double buffer (one group: slices of either layout, so that
// K5's delta chain can reuse it).
template <typename T, int TM, int NG>
constexpr size_t fwd_smem() {
  constexpr int wb = NG == 1 ? 2 * wstage<T>() : 2 * NG * wstage_of<T, false>();
  return (size_t)TM * CLD * 4 + 2 * (size_t)TM * lda<T>() * sizeof(T)
         + (size_t)TM * ldp<T>() * sizeof(T)
         + (size_t)TM * ldd<T>() * sizeof(T) + (size_t)wb * sizeof(T)
         + (size_t)TM * IN_PAD * 4 + (size_t)TM * 4;
}

// Group g's view (rows r0..) of a CTA of TM rows with NG groups.
template <typename T, int TM, int NG>
__device__ FwdSmem<T> fwd_smem_view(unsigned char* smem, int r0, int g) {
  constexpr int WB = NG == 1 ? 2 * wstage<T>() : 2 * wstage_of<T, false>();
  float* C = reinterpret_cast<float*>(smem);
  T* cur = reinterpret_cast<T*>(C + TM * CLD);
  T* nxt = cur + TM * lda<T>();
  T* pe_p = nxt + TM * lda<T>();
  T* pe_d = pe_p + TM * ldp<T>();
  T* wbuf = pe_d + TM * ldd<T>();
  float* xs = reinterpret_cast<float*>(wbuf + NG * WB);
  float* sig = xs + TM * IN_PAD;
  return {C + r0 * CLD, cur + r0 * lda<T>(), nxt + r0 * lda<T>(),
          pe_p + r0 * ldp<T>(), pe_d + r0 * ldd<T>(), wbuf + g * WB,
          xs + r0 * IN_PAD, sig + r0};
}

// Forward epilogue: v = C + b (relu or linear) -> T into the tile buffer
// (row stride ld) and, with SPILL, into the activation spill (row stride
// ACT_PAD).
template <typename T, int TM, int NT, int BAR, bool SPILL>
__device__ void epilogue_fwd(const float* C, const float* bias, int nout,
                             bool relu, T* dst, int ld, T* spill) {
  constexpr int V = pad16<T>();
  const int cpr = nout / V, tid = threadIdx.x % NT;
  for (int c = tid; c < TM * cpr; c += NT) {
    const int r = c / cpr, col = (c % cpr) * V;
    alignas(16) T v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float x = C[r * CLD + col + i] + bias[col + i];
      v[i] = from_f<T>(relu ? fmaxf(x, 0.f) : x);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + col) =
        *reinterpret_cast<const uint4*>(v);
    if constexpr (SPILL)
      *reinterpret_cast<uint4*>(spill + (size_t)r * ACT_PAD + col) =
          *reinterpret_cast<const uint4*>(v);
  }
  group_sync<NT, BAR>();
}

// x rows -> shared memory, and the positional encodings, interleaved
// [sin_f(3), cos_f(3)] per frequency f, zero-padded: pe_p (10 freqs of pos)
// at spill cols 0..63, pe_d (4 of dir) at 64..95; the spill's pad cols
// 2528..2559 are zeroed.
template <typename T, int TM, int NT, int BAR, bool SPILL>
__device__ void fwd_pe(const float* x, const FwdSmem<T>& s, T* spill) {
  const int tid = threadIdx.x % NT;
  for (int i = tid; i < TM * IN_PAD; i += NT) s.xs[i] = x[i];
  group_sync<NT, BAR>();
  for (int i = tid; i < TM * (PE_POS + PE_DIR); i += NT) {
    const int r = i / (PE_POS + PE_DIR), j = i % (PE_POS + PE_DIR);
    const bool pos = j < PE_POS;
    const int jj = pos ? j : j - PE_POS;
    float v = 0.f;
    if (jj < 6 * (pos ? 10 : 4)) {
      const int f = jj / 6, rem = jj % 6, d = rem % 3 + (pos ? 0 : 3);
      const float a = s.xs[r * IN_PAD + d] * (float)(1 << f);
      v = rem < 3 ? sinf(a) : cosf(a);
    }
    const T tv = from_f<T>(v);
    if (pos) s.pe_p[r * ldp<T>() + jj] = tv;
    else s.pe_d[r * ldd<T>() + jj] = tv;
    if constexpr (SPILL) spill[(size_t)r * ACT_PAD + j] = tv;
  }
  if constexpr (SPILL) {
    for (int i = tid; i < TM * (ACT_PAD - ACT_W); i += NT) {
      const int r = i / (ACT_PAD - ACT_W), j = i % (ACT_PAD - ACT_W);
      spill[(size_t)r * ACT_PAD + ACT_W + j] = from_f<T>(0.f);
    }
  }
  group_sync<NT, BAR>();
}

// The layers after the PE.  SPILL: every activation to the spill; OUT: the
// heads and the output rows [rgb(3), sigma, 0, 0, 0, 0].
template <typename T, int TM, int NT, int BAR, bool SPILL, bool OUT>
__device__ void fwd_layers(const Params& P, const FwdSmem<T>& s, float* out,
                           T* spill) {
  constexpr int LDA = lda<T>();
  const int tid = threadIdx.x % NT;
  auto W = [&](int i) { return reinterpret_cast<const T*>(P.p[i]); };
  auto Bv = [&](int i) { return reinterpret_cast<const float*>(P.p[i]); };
  T* cur = s.cur;
  T* nxt = s.nxt;

  Operand<T> o[2];
  o[0] = {s.pe_p, ldp<T>(), PE_POS, W(W0)};
  layer_mm<T, TM, false, NT, BAR>(o, 1, HID, s.wbuf, s.C);
  epilogue_fwd<T, TM, NT, BAR, SPILL>(s.C, Bv(B0), HID, true, cur, LDA,
                                      spill + A_H0);
  for (int l = 1; l <= 7; ++l) {  // h1..h7; h5 adds the skip product
    if (l == 5) {
      o[0] = {s.pe_p, ldp<T>(), PE_POS, W(W5A)};
      o[1] = {cur, LDA, HID, W(W5B)};
      layer_mm<T, TM, false, NT, BAR>(o, 2, HID, s.wbuf, s.C);
    } else {
      const int wi = l < 5 ? W0 + 2 * l : (l == 6 ? W6 : W7);
      o[0] = {cur, LDA, HID, W(wi)};
      layer_mm<T, TM, false, NT, BAR>(o, 1, HID, s.wbuf, s.C);
    }
    const int bi = l < 5 ? B0 + 2 * l : (l == 5 ? B5 : (l == 6 ? B6 : B7));
    epilogue_fwd<T, TM, NT, BAR, SPILL>(s.C, Bv(bi), HID, true, nxt, LDA,
                                        spill + A_H0 + l * HID);
    T* tmp = cur; cur = nxt; nxt = tmp;
  }
  if constexpr (OUT) {  // sigma head from h7 (cur), before its buffer is reused
    const T* ws = W(WS);
    for (int r = tid; r < TM; r += NT) {
      float sg = 0.f;
      for (int k = 0; k < HID; ++k)
        sg += to_f(cur[r * LDA + k]) * to_f(ws[k * OUT_PAD]);
      s.sig[r] = fmaxf(sg + Bv(BS)[0], 0.f);
    }
  }
  // hd = h7 @ W8 + b8 (linear)
  o[0] = {cur, LDA, HID, W(W8)};
  layer_mm<T, TM, false, NT, BAR>(o, 1, HID, s.wbuf, s.C);
  epilogue_fwd<T, TM, NT, BAR, SPILL>(s.C, Bv(B8), HID, false, nxt, LDA,
                                      spill + A_HD);
  // h9 = relu(hd @ W9a + pe_d @ W9b + b9), 128 wide, into h7's buffer
  o[0] = {nxt, LDA, HID, W(W9A)};
  o[1] = {s.pe_d, ldd<T>(), PE_DIR, W(W9B)};
  layer_mm<T, TM, false, NT, BAR>(o, 2, RGB_HID, s.wbuf, s.C);
  epilogue_fwd<T, TM, NT, BAR, SPILL>(s.C, Bv(B9), RGB_HID, true, cur, LDA,
                                      spill + A_H9);
  if constexpr (OUT) {  // rgb head and the output rows
    const T* wr = W(WR);
    const float* br = Bv(BR);
    for (int i = tid; i < TM * OUT_PAD; i += NT) {
      const int r = i / OUT_PAD, c = i % OUT_PAD;
      float v = 0.f;
      if (c < 3) {
        float sg = 0.f;
        for (int k = 0; k < RGB_HID; ++k)
          sg += to_f(cur[r * LDA + k]) * to_f(wr[k * OUT_PAD + c]);
        v = 1.f / (1.f + expf(-(sg + br[c])));
      } else if (c == 3) {
        v = s.sig[r];
      }
      out[(size_t)r * OUT_PAD + c] = v;
    }
  }
}

// K1 (SPILL) and K3: one CTA per TM rows.
template <typename T, int TM, bool SPILL>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const float* __restrict__ x, Params P, float* __restrict__ out,
           T* __restrict__ acts) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t row0 = (size_t)blockIdx.x * TM;
  const FwdSmem<T> s = fwd_smem_view<T, TM, 1>(smem, 0, 0);
  T* spill = SPILL ? acts + row0 * ACT_PAD : nullptr;
  fwd_pe<T, TM, THREADS, 0, SPILL>(x + row0 * IN_PAD, s, spill);
  fwd_layers<T, TM, THREADS, 0, SPILL, true>(P, s, out + row0 * OUT_PAD,
                                             spill);
}

// K6: warpgroup g of the CTA owns rows g * TM / 2 .. with named barrier
// 1 + g; group 1 waits at barrier 3 until group 0 has finished its PE.
constexpr int GROUP = 128;
template <typename T, int TM>
__global__ void __launch_bounds__(THREADS, 1)
fwd_pipelined_kernel(const float* __restrict__ x, Params P,
                     float* __restrict__ out) {
  constexpr int H = TM / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = threadIdx.x / GROUP;
  const size_t row0 = (size_t)blockIdx.x * TM + g * H;
  const FwdSmem<T> s = fwd_smem_view<T, TM, 2>(smem, g * H, g);
  if (g == 0) {
    fwd_pe<T, H, GROUP, 1, false>(x + row0 * IN_PAD, s, nullptr);
    asm volatile("bar.arrive 3, %0;\n" ::"n"(THREADS) : "memory");
    fwd_layers<T, H, GROUP, 1, false, true>(P, s, out + row0 * OUT_PAD,
                                            nullptr);
  } else {
    asm volatile("bar.sync 3, %0;\n" ::"n"(THREADS) : "memory");
    fwd_pe<T, H, GROUP, 2, false>(x + row0 * IN_PAD, s, nullptr);
    fwd_layers<T, H, GROUP, 2, false, true>(P, s, out + row0 * OUT_PAD,
                                            nullptr);
  }
}

// ---------------------------------------------------------------------------
// fp32: the delta chain (K2 (a), and K5 after its recompute)
// ---------------------------------------------------------------------------

// Backward epilogue: d = (C [+ dsig * Ws[:, 0]]) * (act > 0) -> T into the
// tile buffer and the delta workspace.
template <typename T, int TM>
__device__ void epilogue_bwd(const float* C, const T* act, const float* dsig,
                             const T* ws, T* dst, int ld, T* dl) {
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
    *reinterpret_cast<uint4*>(dst + r * ld + col) =
        *reinterpret_cast<const uint4*>(v);
    *reinterpret_cast<uint4*>(dl + (size_t)r * DELTA_W + col) =
        *reinterpret_cast<const uint4*>(v);
  }
  __syncthreads();
}

template <typename T, int TM>
constexpr size_t delta_smem() {
  return (size_t)TM * CLD * 4 + 2 * (size_t)TM * lda<T>() * sizeof(T)
         + 2 * (size_t)wstage<T>() * sizeof(T) + (size_t)TM * 16 * 4;
}

// The chain for one tile of TM rows from its activations `act` (row stride
// ACT_PAD) and output gradient dy, every delta to `dl` (row stride DELTA_W).
template <typename T, int TM>
__device__ void delta_tile(const Params& P, const float* dy, const T* act,
                           T* dl, unsigned char* smem) {
  constexpr int LDA = lda<T>();
  float* C = reinterpret_cast<float*>(smem);
  T* cur = reinterpret_cast<T*>(C + TM * CLD);
  T* nxt = cur + TM * LDA;
  T* wbuf = nxt + TM * LDA;
  float* small = reinterpret_cast<float*>(wbuf + 2 * wstage<T>());
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
      v = dy[(size_t)r * OUT_PAD + c] * rgb * (1.f - rgb);
    } else if (c == 8) {
      float s = 0.f;
      for (int k = 0; k < HID; ++k)
        s += to_f(act[(size_t)r * ACT_PAD + A_H0 + 7 * HID + k])
             * to_f(W(WS)[k * OUT_PAD]);
      const float sg = fmaxf(s + Bv(BS)[0], 0.f);
      v = sg > 0.f ? dy[(size_t)r * OUT_PAD + 3] : 0.f;
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

// K2 (a): the chain from the saved activations.
template <typename T, int TM>
__global__ void __launch_bounds__(THREADS, 1)
bwd_delta_kernel(Params P, const float* __restrict__ dy,
                 const T* __restrict__ acts, T* __restrict__ deltas) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t row0 = (size_t)blockIdx.x * TM;
  delta_tile<T, TM>(P, dy + row0 * OUT_PAD, acts + row0 * ACT_PAD,
                    deltas + row0 * DELTA_W, smem);
}

template <typename T, int TM>
constexpr size_t recompute_smem() {
  return fwd_smem<T, TM, 1>() > delta_smem<T, TM>() ? fwd_smem<T, TM, 1>()
                                                    : delta_smem<T, TM>();
}

// K5 per tile: K1's forward into the chunk's activation workspace, then the
// chain.  x and dy start at the chunk; acts and deltas are written and read
// here, so they carry no __restrict__ (no read-only loads of them).
template <typename T, int TM>
__global__ void __launch_bounds__(THREADS, 1)
bwd_recompute_kernel(const float* __restrict__ x, Params P,
                     const float* __restrict__ dy, T* acts, T* deltas,
                     T* __restrict__ pe_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t row0 = (size_t)blockIdx.x * TM;
  T* at = acts + row0 * ACT_PAD;
  T* dl = deltas + row0 * DELTA_W;
  const FwdSmem<T> s = fwd_smem_view<T, TM, 1>(smem, 0, 0);
  fwd_pe<T, TM, THREADS, 0, true>(x + row0 * IN_PAD, s, at);
  fwd_layers<T, TM, THREADS, 0, true, false>(P, s, nullptr, at);
  delta_tile<T, TM>(P, dy + row0 * OUT_PAD, at, dl, smem);
  if (pe_out) {  // dh9 | dh5 | dh0 for K4 (delta_tile ends synchronised)
    constexpr int V = pad16<T>(), CPR = PE_DW / V;
    T* po = pe_out + row0 * PE_DW;
    for (int i = threadIdx.x; i < TM * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * V;
      const int src = c < RGB_HID ? D_DH9 + c
                      : (c < RGB_HID + HID ? D_DH5 + c - RGB_HID
                                           : D_DH0 + c - RGB_HID - HID);
      *reinterpret_cast<uint4*>(po + (size_t)r * PE_DW + c) =
          *reinterpret_cast<const uint4*>(dl + (size_t)r * DELTA_W + src);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: K4, the input gradient through the PE
// ---------------------------------------------------------------------------

constexpr int DX_TM = 32;                   // points per CTA: one per lane
// fp32 delta row stride in smem: 16-byte aligned rows whose float4 reads by
// the lanes of a quarter warp fall in distinct banks
constexpr int DX_LD = PE_DW + 4;
constexpr int DPE_W = PE_POS + PE_DIR;      // 96
constexpr size_t DX_SMEM =
    ((size_t)DX_TM * DX_LD + (size_t)DX_TM * (DPE_W + 1) + DX_TM * IN_PAD) * 4;

constexpr int JB = 4;  // dpe columns per thread

// acc[jj] += sum_k dv[k] w[jj * kdim + k] for k = 0..kdim-1 in order, jj <
// JB: dv a row of deltas in shared memory, w JB rows of weights (kdim
// apart), read 16 bytes at a time.
__device__ __forceinline__ void dx_dot(const float* dv, const float* w,
                                       int kdim, float* acc) {
  for (int k = 0; k < kdim; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(dv + k);
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const float4 wv = *reinterpret_cast<const float4*>(w + jj * kdim + k);
      acc[jj] += a.x * wv.x;
      acc[jj] += a.y * wv.y;
      acc[jj] += a.z * wv.z;
      acc[jj] += a.w * wv.w;
    }
  }
}

// grid n / DX_TM.  dh9/dh5/dh0 rows have stride ld (elements).
__global__ void __launch_bounds__(THREADS)
dx_kernel(const float* __restrict__ x, Params P, const float* __restrict__ dh9,
          const float* __restrict__ dh5, const float* __restrict__ dh0, int ld,
          float* __restrict__ dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* d = reinterpret_cast<float*>(smem);    // [DX_TM][DX_LD]
  float* dpe = d + DX_TM * DX_LD;               // [DX_TM][DPE_W + 1]
  float* xs = dpe + DX_TM * (DPE_W + 1);        // [DX_TM][IN_PAD]
  const size_t row0 = (size_t)blockIdx.x * DX_TM;
  auto W = [&](int i) { return reinterpret_cast<const float*>(P.p[i]); };

  // the tile's deltas: all of a thread's 16-byte loads, then its stores
  constexpr int CPR = PE_DW / 4, PER = DX_TM * CPR / THREADS;
  static_assert(DX_TM * CPR % THREADS == 0, "whole loads per thread");
  float4 raw[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = threadIdx.x + it * THREADS, r = i / CPR, c = (i % CPR) * 4;
    const size_t row = (row0 + r) * (size_t)ld;
    const float* src = c < RGB_HID ? dh9 + row + c
                       : (c < RGB_HID + HID ? dh5 + row + c - RGB_HID
                                            : dh0 + row + c - RGB_HID - HID);
    raw[it] = *reinterpret_cast<const float4*>(src);
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = threadIdx.x + it * THREADS, r = i / CPR, c = (i % CPR) * 4;
    *reinterpret_cast<float4*>(d + r * DX_LD + c) = raw[it];
  }
  for (int i = threadIdx.x; i < DX_TM * IN_PAD; i += THREADS)
    xs[i] = x[row0 * IN_PAD + i];
  __syncthreads();
  // dpe[r, j]: lane = point r; each warp takes blocks of JB columns (warp-
  // uniform: the weights' 16-byte loads are broadcasts) and sums over k in
  // order; pe_p cols 60..63 and pe_d cols 24..31 are padding (zero).
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* dr = d + lane * DX_LD;
  float* out_r = dpe + lane * (DPE_W + 1);
  for (int blk = warp; blk < DPE_W / JB; blk += THREADS / 32) {
    const int j0 = blk * JB;
    const bool pos = j0 < PE_POS;
    float acc[2][JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) acc[0][jj] = acc[1][jj] = 0.f;
    if (pos ? j0 >= 60 : j0 - PE_POS >= 24) {
      // padding columns
    } else if (pos) {  // dh5 W5a^T and dh0 W0^T, summed apart
      dx_dot(dr + RGB_HID, W(W5A) + j0 * HID, HID, acc[0]);
      dx_dot(dr + RGB_HID + HID, W(W0) + j0 * HID, HID, acc[1]);
    } else {  // dh9 W9b^T
      dx_dot(dr, W(W9B) + (j0 - PE_POS) * RGB_HID, RGB_HID, acc[0]);
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) out_r[j0 + jj] = acc[0][jj] + acc[1][jj];
  }
  __syncthreads();
  // dx[r, c] = sum_f 2^f (dpe[sin_f] cos(2^f x) - dpe[cos_f] sin(2^f x))
  {
    const int r = threadIdx.x / IN_PAD, c = threadIdx.x % IN_PAD;
    float g = 0.f;
    if (c < 6) {
      const bool pos = c < 3;
      const int n_freq = pos ? 10 : 4, dd = pos ? c : c - 3;
      const float* dp = dpe + r * (DPE_W + 1) + (pos ? 0 : PE_POS);
      const float xv = xs[r * IN_PAD + c];
      for (int f = 0; f < n_freq; ++f) {
        const float sc = (float)(1 << f), a = xv * sc;
        g += sc * (dp[f * 6 + dd] * cosf(a) - dp[f * 6 + 3 + dd] * sinf(a));
      }
    }
    dx[(row0 + r) * IN_PAD + c] = g;
  }
}

// ---------------------------------------------------------------------------
// bf16: the forward and the delta chain on wgmma, one weight stream per CTA
// ---------------------------------------------------------------------------
//
// tile_mm.cuh's per-tile machinery (section "bf16 per-tile pass", shared
// with film_mlp.cu): two consumer warpgroups, one 64-point tile each, on one
// TMA ring of 32-row weight slices that a producer warpgroup fills; each
// product is wgmma.m64n256k16 with a K-major A in shared memory; the
// epilogues run on the accumulator registers, overwrite A in place, and A
// goes to the spill or the delta workspace by TMA.
//
// nerf_fwd_tc_kernel (K1 with SPILL; K3, K6 and K5's recompute without)
// streams the forward stack [W0 | W1..W4 | W5a | W5b | W6 | W7 | W8 | W9a |
// W9b] (ops/kernels/nerf_mlp.py::weight_stacks: 2,464 rows, W9a and W9b
// zero-padded to 256 columns so that every stage is four boxes, ~6% more
// tensor-core work): products of K = 64 (W0, W5a), 256 and 32 (W9b).  Each
// warpgroup computes its tile's PEs on the CUDA cores (accurate sinf/cosf:
// the arguments reach ~3,000 rad) into two resident K-major blocks (pe_p,
// 64 columns; pe_d, 32 columns of a block) and, with SPILL, into spill
// columns 0..95.  h5 and h9 are two products into one register set (pe_p
// W5a + h4 W5b, hd W9a + pe_d W9b).  Epilogue: bias + relu (hd linear) ->
// bf16 into A; with SPILL, A -> the spill by TMA.  sigma comes from h7's
// epilogue and rgb from h9's (each lane's partial sums over its columns,
// then a shuffle across the quad).  K6's two chains are the two
// warpgroups on one weight stream.
//
// nerf_bwd_delta_tc_kernel (K2 (a), and K5's chain after its recompute)
// streams the backward stack [W9a^T, W8^T, W7^T, W6^T, W5b^T, W4^T, ...,
// W1^T] (2,176 rows): dhd (K = 128), then eight products of K = 256.  The
// heads are rebuilt from the saved h9 and h7, staged by TMA (h9 into A's
// blocks 2 and 3, h7 into the mask buffer); dr and dsig go to delta columns
// 0..15, and dh9 = (dr Wr^T) (h9 > 0) is built on the CUDA cores into A.
// Each epilogue adds dsig Ws^T (dh7), masks by h_{l-1} > 0 (read from the
// mask buffer at the address it writes in A; dhd has no mask) and rounds to
// bf16 into A, which goes to the delta workspace (dh9, dh5 and dh0 also to
// K5's copy for K4) by TMA.  The next mask is loaded by TMA into the mask
// buffer while the next product runs.  No atomics: two launches are bitwise
// equal.
//
// What bounds them on an H100: bytes.  The delta chain moves 9,280 B per
// point (reads h0..h7 and h9 for the masks and heads and dy; writes 2,448
// delta columns): ~0.18 ms at 65,536 points at 3.35 TB/s against ~0.07 ms
// of tensor-core work; K1 writes 5,120 B of spill per point (~0.10 ms).
// Their epilogues are a few instructions per element (no sine).

constexpr int NF_STAGES = 77;  // forward stack: 2,464 rows of KS
constexpr int NB_STAGES = 68;  // backward stack: 2,176 rows of KS
// The epilogues walk the accumulators in blocks of TC_JB steps of j
// (tile_mm.cuh's acc_block): of blocks of 2, 4, 8 and 16, 8 ran K1 and K3
// fastest (tools/torch_nerf_probe.py).
constexpr int TC_JB = 8;
// forward: per warpgroup the PE blocks (pe_p, pe_d), then the heads [64][4]
// (rgb, sigma; fp32)
constexpr int NF_PE = 2 * TC_A_BLOCK, NF_HEAD = TC_TILE * 4;
constexpr int NF_EXTRA = 2 * NF_PE + 2 * NF_HEAD * 4;
constexpr size_t NF_SMEM = tc_smem(NF_EXTRA);
static_assert(NF_SMEM <= 232448, "the NeRF forward exceeds shared memory");
// backward: per warpgroup a mask buffer (A's layout), then the heads'
// deltas [64] x (dr0, dr1, dr2, dsig) in bf16, then a mask barrier each
constexpr int NB_HD = TC_TILE * 8;
constexpr int NB_EXTRA = 2 * TC_A_BYTES + 2 * NB_HD + 2 * 8;
constexpr size_t NB_SMEM = tc_smem(NB_EXTRA);
static_assert(NB_SMEM <= 232448, "the NeRF delta chain exceeds shared memory");

// The tile's positional encodings (x rows at x), interleaved [sin_f(3),
// cos_f(3)] per frequency f and zero-padded as fwd_pe computes them, into
// the warpgroup's PE blocks (pe_p at pe, pe_d at pe + TC_A_BLOCK) and, with
// SPILL, spill columns 0..95; the spill's pad columns 2528..2559 are
// zeroed.  Ends with the blocks visible to the wgmma.
template <bool SPILL>
__device__ void tc_pe(const TcCtx& c, const float* x, unsigned char* pe,
                      bf16_t* spill) {
  constexpr int NQ = 3 * (10 + 4);  // (frequency, dimension) of pos, dir
  for (int i = c.tid; i < TC_TILE * NQ; i += TC_WG) {
    const int r = i / NQ, q = i % NQ, fq = q / 3, d = q % 3;
    const bool pos = fq < 10;
    const int f = pos ? fq : fq - 10, col = 6 * f + d;
    const float a = x[r * IN_PAD + (pos ? d : 3 + d)] * (float)(1 << f);
    const bf16_t sv = __float2bfloat16(sinf(a)), cv = __float2bfloat16(cosf(a));
    unsigned char* blk = pe + (pos ? 0 : TC_A_BLOCK);
    *reinterpret_cast<bf16_t*>(blk + swizzled(r, col)) = sv;
    *reinterpret_cast<bf16_t*>(blk + swizzled(r, col + 3)) = cv;
    if constexpr (SPILL) {
      bf16_t* sp = spill + (size_t)r * ACT_PAD + (pos ? 0 : PE_POS) + col;
      sp[0] = sv;
      sp[3] = cv;
    }
  }
  // the padding the products read: pe_p columns 60..63, pe_d 24..31
  for (int i = c.tid; i < TC_TILE * 12; i += TC_WG) {
    const int r = i / 12, j = i % 12;
    const bool pos = j < 4;
    const int col = pos ? 60 + j : 20 + j;
    const bf16_t z = __float2bfloat16(0.f);
    *reinterpret_cast<bf16_t*>(pe + (pos ? 0 : TC_A_BLOCK) + swizzled(r, col))
        = z;
    if constexpr (SPILL)
      spill[(size_t)r * ACT_PAD + (pos ? 0 : PE_POS) + col] = z;
  }
  if constexpr (SPILL) {
    for (int i = c.tid; i < TC_TILE * 4; i += TC_WG)
      *reinterpret_cast<uint4*>(spill + (size_t)(i / 4) * ACT_PAD + ACT_W
                                + (i % 4) * 8) = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  wg_sync(c);
}

// What a forward epilogue does besides bias and relu (compile-time, so the
// unrolled walk has no branches to schedule around).
enum { EPI_LINEAR = 1, EPI_SIGMA = 2, EPI_RGB = 4 };

// Forward epilogue on the accumulators: v = acc + b, relu unless
// EPI_LINEAR, -> bf16 into A (columns 0..127 with EPI_RGB: h9); sigma =
// relu(h7 Ws + bs) (EPI_SIGMA) or rgb = sigmoid(h9 Wr + br) (EPI_RGB) from
// the rounded values into the heads (c.scr); with SPILL, A -> the spill's
// columns col0.. by TMA.  Ends with the warpgroup synchronised and A
// visible to the next wgmma.
template <int KIND, bool SPILL>
__device__ __forceinline__ void tc_fwd_epi(const TcCtx& c, const float* acc,
                                           const float* bias,
                                           const bf16_t* wh, const float* bh,
                                           const CUtensorMap* amap,
                                           int col0) {
  constexpr bool RELU = !(KIND & EPI_LINEAR);
  constexpr int NH = (KIND & EPI_RGB) ? 3 : ((KIND & EPI_SIGMA) ? 1 : 0);
  constexpr int NCOL = (KIND & EPI_RGB) ? RGB_HID : HID;
  static_assert(NCOL / 8 % TC_JB == 0, "whole blocks of the walk");
  const int r0 = c.warp * 16 + c.lane / 4;
  float hs[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll 1
  for (int jb = 0; jb < NCOL / 8; jb += TC_JB) {
    float a[4 * TC_JB];
    acc_block<TC_JB>(acc, jb, a);
#pragma unroll
    for (int jj = 0; jj < TC_JB; ++jj) {
      const int col = 8 * (jb + jj) + 2 * (c.lane % 4);
      const float2 bc = ld2(bias + col);
      float whc[2][3];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
#pragma unroll
        for (int q = 0; q < NH; ++q)
          whc[cc][q] = __bfloat162float(__ldg(wh + (col + cc) * OUT_PAD + q));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = a[4 * jj + 2 * h] + bc.x, v1 = a[4 * jj + 2 * h + 1] + bc.y;
        if constexpr (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const __nv_bfloat162 hb = __floats2bfloat162_rn(v0, v1);
        stb2(c.ag + a_offset(r0 + 8 * h, col), hb);
        if constexpr (NH > 0) {
          const float2 hf = __bfloat1622float2(hb);
#pragma unroll
          for (int q = 0; q < NH; ++q)
            hs[h][q] += hf.x * whc[0][q] + hf.y * whc[1][q];
        }
      }
    }
  }
  if constexpr (NH > 0) {
    // a row's columns lie in the 4 lanes that share lane / 4
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < NH; ++q)
#pragma unroll
        for (int o = 1; o < 4; o <<= 1)
          hs[h][q] += __shfl_xor_sync(0xffffffffu, hs[h][q], o);
    if (c.lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* hd = c.scr + (r0 + 8 * h) * 4;
        if constexpr (NH == 1) {
          hd[3] = fmaxf(hs[h][0] + bh[0], 0.f);
        } else {
#pragma unroll
          for (int q = 0; q < 3; ++q)
            hd[q] = 1.f / (1.f + expf(-(hs[h][q] + bh[q])));
        }
      }
    }
  }
  fence_proxy_async();
  wg_sync(c);
  if constexpr (SPILL) tc_store_a(c, amap, col0, NCOL / DW_BOX);
}

// K1 (SPILL) and K3 / K6 / K5's recompute, bf16: grid (tiles + 1) / 2; x
// [n, 8]; out [n, 8] unless null; with SPILL the spill [n, ACT_PAD] (acts,
// and amap over it).
template <bool SPILL>
__global__ void __launch_bounds__(TC_THREADS, 1)
nerf_fwd_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap amap,
                   const float* __restrict__ x, Params P,
                   float* __restrict__ out, bf16_t* __restrict__ acts,
                   int n_tiles) {
  extern __shared__ unsigned char tc_smem_raw[];
  TcCtx c = tc_setup(tc_smem_raw, NF_EXTRA);
  if (threadIdx.x >= TC_CONSUMERS) {
    tc_regs_producer();
    if (threadIdx.x == TC_CONSUMERS)
      tc_produce(c.ring, c.bars, &wmap, NF_STAGES, 0);
    return;
  }
  tc_regs_consumer();
  const int tile = 2 * blockIdx.x + c.wg;
  if (tile >= n_tiles) {
    tc_idle(c, NF_STAGES);
    return;
  }
  auto W = [&](int i) { return reinterpret_cast<const bf16_t*>(P.p[i]); };
  auto Bv = [&](int i) { return reinterpret_cast<const float*>(P.p[i]); };
  c.row0 = tile * TC_TILE;
  const size_t row0 = (size_t)c.row0;
  const uint32_t pe_p = tc_ext(c) + c.wg * NF_PE, pe_d = pe_p + TC_A_BLOCK;
  c.scr = reinterpret_cast<float*>(tc_ext_ptr(c) + 2 * NF_PE) + c.wg * NF_HEAD;
  tc_pe<SPILL>(c, x + row0 * IN_PAD, tc_ext_ptr(c) + c.wg * NF_PE,
               SPILL ? acts + row0 * ACT_PAD : nullptr);

  float acc[HID / 2];
  tc_product<PE_POS / KS>(c, acc, pe_p, 0);  // h0 = relu(pe_p W0 + b0)
  tc_fwd_epi<0, SPILL>(c, acc, Bv(B0), nullptr, nullptr, &amap, A_H0);
  for (int l = 1; l < 5; ++l) {  // h1..h4
    tc_product<HID / KS>(c, acc, c.a, 0);
    tc_fwd_epi<0, SPILL>(c, acc, Bv(B0 + 2 * l), nullptr, nullptr, &amap,
                         A_H0 + l * HID);
  }
  tc_product<PE_POS / KS>(c, acc, pe_p, 0);  // h5 = relu(pe_p W5a + h4 W5b
  tc_product<HID / KS>(c, acc, c.a, 1);      //          + b5)
  tc_fwd_epi<0, SPILL>(c, acc, Bv(B5), nullptr, nullptr, &amap,
                       A_H0 + 5 * HID);
  tc_product<HID / KS>(c, acc, c.a, 0);  // h6
  tc_fwd_epi<0, SPILL>(c, acc, Bv(B6), nullptr, nullptr, &amap,
                       A_H0 + 6 * HID);
  tc_product<HID / KS>(c, acc, c.a, 0);  // h7, and sigma from it
  tc_fwd_epi<EPI_SIGMA, SPILL>(c, acc, Bv(B7), W(WS), Bv(BS), &amap,
                               A_H0 + 7 * HID);
  tc_product<HID / KS>(c, acc, c.a, 0);  // hd = h7 W8 + b8 (linear)
  tc_fwd_epi<EPI_LINEAR, SPILL>(c, acc, Bv(B8), nullptr, nullptr, &amap,
                                A_HD);
  tc_product<HID / KS>(c, acc, c.a, 0);  // h9 = relu(hd W9a + pe_d W9b + b9)
  tc_product<PE_DIR / KS>(c, acc, pe_d, 1);
  tc_fwd_epi<EPI_RGB, SPILL>(c, acc, Bv(B9), W(WR), Bv(BR), &amap, A_H9);
  if (out) {  // the rows [rgb(3), sigma, 0, 0, 0, 0]
    for (int i = c.tid; i < TC_TILE * OUT_PAD; i += TC_WG) {
      const int r = i / OUT_PAD, q = i % OUT_PAD;
      out[row0 * OUT_PAD + i] = q < 4 ? c.scr[r * 4 + q] : 0.f;
    }
  }
  if (SPILL && c.tid == 0) bulk_wait<0>();  // the spill's TMA writes are done
}

// The heads rebuilt from the staged h7 (mask buffer) and h9 (A's blocks 2
// and 3): sigma = relu(h7 Ws + bs), rgb = sigmoid(h9 Wr + br); dr = dy_rgb
// rgb (1 - rgb) and dsig = dy_sigma (sigma > 0), rounded to bf16, into
// delta columns 0..15 (dl, the tile's rows) and the scratch (dr0, dr1, dr2,
// dsig per point).  One warp per point, a fixed butterfly reduction.
__device__ void tc_heads(const TcCtx& c, const float* dy,
                         const unsigned char* h7, const bf16_t* ws,
                         const float* bs, const bf16_t* wr, const float* br,
                         bf16_t* dl) {
  __nv_bfloat162* hd = reinterpret_cast<__nv_bfloat162*>(c.scr);
  for (int r = c.warp; r < TC_TILE; r += TC_WG / 32) {
    float s7 = 0.f, s9[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < HID; k += 64) {
      const int col = k + 2 * c.lane;
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(h7 + a_offset(r, col)));
      s7 += h.x * __bfloat162float(__ldg(ws + col * OUT_PAD))
            + h.y * __bfloat162float(__ldg(ws + (col + 1) * OUT_PAD));
    }
#pragma unroll
    for (int k = 0; k < RGB_HID; k += 64) {
      const int col = k + 2 * c.lane;
      const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          c.ag + a_offset(r, RGB_HID + col)));
#pragma unroll
      for (int q = 0; q < 3; ++q)
        s9[q] += h.x * __bfloat162float(__ldg(wr + col * OUT_PAD + q))
                 + h.y * __bfloat162float(__ldg(wr + (col + 1) * OUT_PAD + q));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s7 += __shfl_xor_sync(0xffffffffu, s7, o);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        s9[q] += __shfl_xor_sync(0xffffffffu, s9[q], o);
    }
    if (c.lane == 0) {
      const float* d = dy + (size_t)r * OUT_PAD;
      bf16_t v[4];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float rgb = 1.f / (1.f + expf(-(s9[q] + br[q])));
        v[q] = __float2bfloat16(
            __fmul_rn(__fmul_rn(d[q], rgb), __fsub_rn(1.f, rgb)));
      }
      const float sg = fmaxf(s7 + bs[0], 0.f);
      v[3] = __float2bfloat16(sg > 0.f ? d[3] : 0.f);
      hd[2 * r] = __halves2bfloat162(v[0], v[1]);
      hd[2 * r + 1] = __halves2bfloat162(v[2], v[3]);
      const unsigned b01 = __bfloat16_as_ushort(v[0])
                           | (unsigned)__bfloat16_as_ushort(v[1]) << 16;
      uint4* row = reinterpret_cast<uint4*>(dl + (size_t)r * DELTA_W);
      row[0] = make_uint4(b01, __bfloat16_as_ushort(v[2]), 0, 0);
      row[1] = make_uint4(__bfloat16_as_ushort(v[3]), 0, 0, 0);
    }
  }
  wg_sync(c);
}

// dh9 = (dr Wr^T) (h9 > 0) on the CUDA cores into A's blocks 0 and 1 (h9
// in blocks 2 and 3).  Ends with A fenced and the warpgroup synchronised.
__device__ void tc_dh9(const TcCtx& c, const bf16_t* wr) {
  const __nv_bfloat162* hd = reinterpret_cast<const __nv_bfloat162*>(c.scr);
  for (int i = c.tid; i < TC_TILE * RGB_HID / 2; i += TC_WG) {
    const int r = i / (RGB_HID / 2), col = 2 * (i % (RGB_HID / 2));
    const float2 d01 = __bfloat1622float2(hd[2 * r]);
    const float d2 = __bfloat1622float2(hd[2 * r + 1]).x;
    float s[2];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const bf16_t* w = wr + (col + cc) * OUT_PAD;
      s[cc] = d01.x * __bfloat162float(__ldg(w))
              + d01.y * __bfloat162float(__ldg(w + 1))
              + d2 * __bfloat162float(__ldg(w + 2));
    }
    const float2 m = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        c.ag + a_offset(r, RGB_HID + col)));
    stb2(c.ag + a_offset(r, col),
         __floats2bfloat162_rn(m.x > 0.f ? s[0] : 0.f, m.y > 0.f ? s[1] : 0.f));
  }
  fence_proxy_async();
  wg_sync(c);
}

// Backward epilogue on the accumulators: d = acc (+ dsig Ws[:, 0] with
// DSIG), times (h > 0) with MASK (h the activation staged in the mask
// buffer, read at the address d is written in A), -> bf16 into A.  Ends with
// the warpgroup synchronised and A visible to the next wgmma and to TMA.
template <bool MASK, bool DSIG>
__device__ __forceinline__ void tc_bwd_epi(const TcCtx& c, const float* acc,
                                           const unsigned char* mask,
                                           const bf16_t* ws) {
  const int r0 = c.warp * 16 + c.lane / 4;
  const __nv_bfloat162* hd = reinterpret_cast<const __nv_bfloat162*>(c.scr);
  float ds[2] = {0.f, 0.f};
  if constexpr (DSIG) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ds[h] = __bfloat1622float2(hd[2 * (r0 + 8 * h) + 1]).y;
  }
#pragma unroll 1
  for (int jb = 0; jb < HID / 8; jb += TC_JB) {
    float a[4 * TC_JB];
    acc_block<TC_JB>(acc, jb, a);
#pragma unroll
    for (int jj = 0; jj < TC_JB; ++jj) {
      const int col = 8 * (jb + jj) + 2 * (c.lane % 4);
      float2 w = {0.f, 0.f};
      if constexpr (DSIG) {
        w.x = __bfloat162float(__ldg(ws + col * OUT_PAD));
        w.y = __bfloat162float(__ldg(ws + (col + 1) * OUT_PAD));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = a_offset(r0 + 8 * h, col);
        float v0 = a[4 * jj + 2 * h], v1 = a[4 * jj + 2 * h + 1];
        if constexpr (DSIG) {
          v0 += ds[h] * w.x;
          v1 += ds[h] * w.y;
        }
        if constexpr (MASK) {
          const float2 m = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(mask + off));
          v0 = m.x > 0.f ? v0 : 0.f;
          v1 = m.y > 0.f ? v1 : 0.f;
        }
        stb2(c.ag + off, __floats2bfloat162_rn(v0, v1));
      }
    }
  }
  fence_proxy_async();
  wg_sync(c);
}

// K2 (a) and K5's chain, bf16: grid (tiles + 1) / 2; dy [n, 8]; the spill
// (amap, [n, ACT_PAD]) is read for the heads and the masks; the deltas
// (deltas and dmap, [n, DELTA_W]) are written, columns 0..15 directly and
// the rest by TMA; with pe_row0 >= 0, dh9 | dh5 | dh0 also go to K5's copy
// (pmap, [*, PE_DW]) at rows pe_row0 + the tile's.
__global__ void __launch_bounds__(TC_THREADS, 1)
nerf_bwd_delta_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap amap,
                         const __grid_constant__ CUtensorMap dmap,
                         const __grid_constant__ CUtensorMap pmap, Params P,
                         const float* __restrict__ dy,
                         bf16_t* __restrict__ deltas, int n_tiles,
                         int pe_row0) {
  extern __shared__ unsigned char tc_smem_raw[];
  TcCtx c = tc_setup(tc_smem_raw, NB_EXTRA);
  if (threadIdx.x >= TC_CONSUMERS) {
    tc_regs_producer();
    if (threadIdx.x == TC_CONSUMERS)
      tc_produce(c.ring, c.bars, &wmap, NB_STAGES, 0);
    return;
  }
  tc_regs_consumer();
  const int tile = 2 * blockIdx.x + c.wg;
  if (tile >= n_tiles) {
    tc_idle(c, NB_STAGES);
    return;
  }
  auto W = [&](int i) { return reinterpret_cast<const bf16_t*>(P.p[i]); };
  auto Bv = [&](int i) { return reinterpret_cast<const float*>(P.p[i]); };
  c.row0 = tile * TC_TILE;
  const size_t row0 = (size_t)c.row0;
  const uint32_t mask = tc_ext(c) + c.wg * TC_A_BYTES;
  const unsigned char* mask_g = tc_ext_ptr(c) + c.wg * TC_A_BYTES;
  c.scr = reinterpret_cast<float*>(tc_ext_ptr(c) + 2 * TC_A_BYTES
                                   + c.wg * NB_HD);
  const uint32_t mbar = tc_ext(c) + 2 * TC_A_BYTES + 2 * NB_HD + 8 * c.wg;
  const bool pe = pe_row0 >= 0;

  // h9 into A's blocks 2, 3 and h7 into the mask buffer
  if (c.tid == 0) {
    mbar_init(mbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(mbar, 12 * DW_BOX_BYTES);
    tc_load_tile(c.a + 2 * TC_A_BLOCK, &amap, A_H9, c.row0, 2, mbar);
    tc_load_tile(mask, &amap, A_H0 + 7 * HID, c.row0, 4, mbar);
  }
  wg_sync(c);  // the barrier is initialised before anyone waits on it
  mbar_wait(mbar, 0);
  __syncwarp();  // the warp leaves the wait together (wgmma is .aligned)
  int mph = 1;  // mask loads so far
  tc_heads(c, dy + row0 * OUT_PAD, mask_g, W(WS), Bv(BS), W(WR), Bv(BR),
           deltas + row0 * DELTA_W);
  tc_dh9(c, W(WR));
  tc_store_a(c, &dmap, D_DH9, RGB_HID / DW_BOX);
  if (pe) tc_store_a(c, &pmap, 0, RGB_HID / DW_BOX, pe_row0);

  float acc[HID / 2];
  tc_product<RGB_HID / KS>(c, acc, c.a, 0);  // dhd = dh9 W9a^T (no mask)
  tc_bwd_epi<false, false>(c, acc, mask_g, nullptr);
  tc_store_a(c, &dmap, D_DHD);
  tc_product<HID / KS>(c, acc, c.a, 0);  // dh7 = (dhd W8^T + dsig Ws^T)
  tc_bwd_epi<true, true>(c, acc, mask_g, W(WS));  //   (h7 > 0)
  for (int l = 7; l >= 1; --l) {
    // A holds dh_l and the mask buffer's h_l has been read: h_{l-1} comes
    // in while the next product runs
    if (c.tid == 0) {
      fence_proxy_async();
      mbar_expect_tx(mbar, 8 * DW_BOX_BYTES);
      tc_load_tile(mask, &amap, A_H0 + (l - 1) * HID, c.row0, 4, mbar);
    }
    tc_store_a(c, &dmap, D_DH7 + (7 - l) * HID);
    if (pe && l == 5) tc_store_a(c, &pmap, RGB_HID, 4, pe_row0);
    // dh_{l-1} = (dh_l W_l^T) (h_{l-1} > 0), W5b for l = 5
    tc_product<HID / KS>(c, acc, c.a, 0);
    mbar_wait(mbar, mph & 1);
    __syncwarp();
    ++mph;
    tc_bwd_epi<true, false>(c, acc, mask_g, nullptr);
  }
  tc_store_a(c, &dmap, D_DH0);
  if (pe) tc_store_a(c, &pmap, RGB_HID + HID, 4, pe_row0);
  if (c.tid == 0) bulk_wait<0>();  // the workspaces' TMA writes are done
}

// ---------------------------------------------------------------------------
// bf16: K4 on wgmma
// ---------------------------------------------------------------------------
//
// dx_tc_kernel: a persistent grid (one CTA per SM, or one per tile when
// there are fewer) walks 128-point tiles, tile blockIdx.x + k gridDim.x.  A
// CTA has one producer warp and two consumer warpgroups, 64 points of each
// tile apiece.  The producer's one thread first loads the PE weights W5a,
// W0 (64 x 256) and W9b (32 x 128) by TMA into shared memory, where they
// stay: packed [in, out] with the PE column j as the row and the delta
// column k contiguous, each 64-column block a 128-byte-swizzled box, so
// they are wgmma's B operand, K-major, as they lie (72 KB; PE rows 60..63
// and 24..31 are the packing's zeros).  Then it streams each tile's deltas
// through a ring of DX_STAGES stages, one 64-column box of 128 points (16
// KB) per stage, in DX order: dh5's four boxes, dh0's four, dh9's two.  The
// boxes come from three 2-D tensor maps over the three column views, so one
// kernel reads K2's workspace (row stride 2448) and K5's copy (640) alike.
// Each consumer warpgroup multiplies its 64 rows of a stage, K-major A,
// into dpe_p (wgmma.m64n64k16, dh5's boxes then dh0's: one fp32 sum over
// K = 512) or dpe_d (m64n32k16, K = 128), and releases the stage once its
// wgmmas have retired.  Epilogue: the accumulators to fp32 staging rows
// [64][DX_ST] (dpe_p columns 0..63, dpe_d 64..95), then one thread per dx
// element sums its frequencies, f = 0 up, with accurate sincosf (arguments
// reach ~3,000 rad; no fast math), and stores dx, columns 6 and 7 zero:
// warps 0-1 take the position's elements (10 frequencies), warps 2-3 the
// direction's (4), three elements a thread, so a warp runs 30 or 12
// iterations per tile and no lane idles in them.
// Every tile runs the same instructions on the same shared-memory image
// whatever the CTA count or the delta layout, so two launches are bitwise
// equal and K2's deltas give K5's dx.
//
// What bounds it on an H100: bytes, 1,280 B of deltas and 64 B of x and dx
// per point; each CTA also reads the 72 KB of weights once (from L2).  The
// ring keeps up to 96 KB in flight per SM while the epilogue runs.

constexpr int DX_TILE = 128;                           // points per tile
constexpr int DX_BOX_BYTES = DX_TILE * DW_BOX * 2;     // 16384: one stage
constexpr int DX_BOXES = 2 * HID / DW_BOX + RGB_HID / DW_BOX;  // 10 per tile
constexpr int DX_STAGES = 6;
// the resident weights W5a, W0, W9b at these offsets; a weight's block b
// (delta columns 64 b..64 b + 63: one 128-byte row per PE row, swizzled)
// at b x (its rows) x 128 bytes
constexpr int DXW_W5A = 0, DXW_W0 = PE_POS * HID * 2;
constexpr int DXW_W9B = 2 * PE_POS * HID * 2;
constexpr int DXW_BYTES = DXW_W9B + PE_DIR * RGB_HID * 2;  // 73728
constexpr int DX_ST = PE_POS + PE_DIR + 8;  // fp32 staging row: 104 (float2
                                            // stores without bank conflicts)
constexpr int DX_ST_BYTES = TC_TILE * DX_ST * 4;       // per warpgroup
constexpr int DX_CONSUMERS = 2 * TC_WG;
constexpr int DX_THREADS = DX_CONSUMERS + 32;          // and a producer warp
constexpr size_t DX_TC_SMEM = 1024 + DXW_BYTES
                              + (size_t)DX_STAGES * DX_BOX_BYTES
                              + 2 * (size_t)DX_ST_BYTES
                              + (1 + 2 * DX_STAGES) * 8;
static_assert(DX_TC_SMEM <= 232448, "K4 exceeds shared memory");
static_assert(DXW_BYTES % 1024 == 0 && DX_ST_BYTES % 8 == 0, "alignment");

// D[64, 64] (+)= A[64, 16] B[16, 64]: bf16 operands in shared memory, both
// K-major (no transpose), fp32 accumulators; accumulate = 0 ignores D.
__device__ __forceinline__ void wgmma_m64n64k16_kk(float* d, uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64, 32] (+)= A[64, 16] B[16, 32]: as wgmma_m64n64k16_kk.
__device__ __forceinline__ void wgmma_m64n32k16_kk(float* d, uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The products of stage q of a tile (DX order) for the warpgroup whose 64
// rows of the stage start at shared address a: dpe_p (ap) from dh5's and
// dh0's boxes, dpe_d (ad) from dh9's; the first box of each starts the sum.
__device__ __forceinline__ void dx_box_product(float* ap, float* ad,
                                               uint32_t a, int q,
                                               uint32_t wts) {
#pragma unroll
  for (int k = 0; k < DW_BOX / 16; ++k) {
    const uint64_t da = gmma_desc(a + k * 32, TC_A_LBO, TC_A_SBO);
    if (q < 8) {
      const uint32_t b = wts + (q < 4 ? DXW_W5A : DXW_W0)
                         + (q % 4) * PE_POS * 128 + k * 32;
      wgmma_m64n64k16_kk(ap, da, gmma_desc(b, TC_A_LBO, TC_A_SBO),
                         q > 0 || k > 0);
    } else {
      const uint32_t b = wts + DXW_W9B + (q - 8) * PE_DIR * 128 + k * 32;
      wgmma_m64n32k16_kk(ad, da, gmma_desc(b, TC_A_LBO, TC_A_SBO),
                         q > 8 || k > 0);
    }
  }
}

// the named barrier of consumer warpgroup wg
__device__ __forceinline__ void dx_wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// grid min(SMs, tiles); x and dx [n, 8] fp32; w5a/w0/w9b maps over the
// packed weights (boxes of all their rows), dh5/dh0/dh9 over the delta
// views (boxes of DX_TILE rows).
__global__ void __launch_bounds__(DX_THREADS, 1)
dx_tc_kernel(const __grid_constant__ CUtensorMap w5a_map,
             const __grid_constant__ CUtensorMap w0_map,
             const __grid_constant__ CUtensorMap w9b_map,
             const __grid_constant__ CUtensorMap dh5_map,
             const __grid_constant__ CUtensorMap dh0_map,
             const __grid_constant__ CUtensorMap dh9_map,
             const float* __restrict__ x, float* __restrict__ dx,
             int n_tiles) {
  extern __shared__ unsigned char dx_smem_raw[];
  const uint32_t raw = smem_u32(dx_smem_raw);
  const uint32_t wts = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t ring = wts + DXW_BYTES;
  const uint32_t staging = ring + DX_STAGES * DX_BOX_BYTES;
  const uint32_t wbar = staging + 2 * DX_ST_BYTES;
  const uint32_t full = wbar + 8, empty = full + 8 * DX_STAGES;
  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    for (int s = 0; s < DX_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, DX_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= DX_CONSUMERS) {  // the producer warp: one thread
    if (threadIdx.x == DX_CONSUMERS) {
      mbar_expect_tx(wbar, DXW_BYTES);
      for (int b = 0; b < HID / DW_BOX; ++b) {
        tma_load_2d(wts + DXW_W5A + b * PE_POS * 128, &w5a_map, b * DW_BOX,
                    0, wbar);
        tma_load_2d(wts + DXW_W0 + b * PE_POS * 128, &w0_map, b * DW_BOX, 0,
                    wbar);
      }
      for (int b = 0; b < RGB_HID / DW_BOX; ++b)
        tma_load_2d(wts + DXW_W9B + b * PE_DIR * 128, &w9b_map, b * DW_BOX,
                    0, wbar);
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
        for (int q = 0; q < DX_BOXES; ++q, ++it) {
          const int s = it % DX_STAGES;
          mbar_wait(empty + 8 * s, ((it / DX_STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, DX_BOX_BYTES);
          const CUtensorMap* m =
              q < 4 ? &dh5_map : (q < 8 ? &dh0_map : &dh9_map);
          tma_load_2d(ring + s * DX_BOX_BYTES, m, (q < 8 ? q % 4 : q - 8)
                      * DW_BOX, t * DX_TILE, full + 8 * s);
        }
    }
    return;
  }

  const int wg = threadIdx.x / TC_WG, tid = threadIdx.x % TC_WG;
  const int warp = tid / 32, lane = threadIdx.x % 32;
  float* st = reinterpret_cast<float*>(dx_smem_raw + (staging - raw))
              + wg * TC_TILE * DX_ST;
  // the chain rule's (point, coordinate) pairs: warps 0-1 take the three
  // position coordinates (10 frequencies), warps 2-3 the direction's (4),
  // pair i = ct + 64 k (k < 3) the point i / 3's coordinate i % 3
  const bool dir = warp >= 2;
  const int ct = tid % 64, n_freq = dir ? 4 : 10, c0 = dir ? 3 : 0;
  mbar_wait(wbar, 0);
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const size_t e0 = ((size_t)t * DX_TILE + wg * TC_TILE) * IN_PAD;
    float xv[3];  // the x of this thread's pairs
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = ct + 64 * k;
      xv[k] = __ldg(x + e0 + (i / 3) * IN_PAD + c0 + i % 3);
    }
    float ap[PE_POS / 2], ad[PE_DIR / 2];
#pragma unroll
    for (int q = 0; q < DX_BOXES; ++q, ++it) {
      const int s = it % DX_STAGES;
      mbar_wait(full + 8 * s, (it / DX_STAGES) & 1);
      __syncwarp();  // wgmma is .aligned: the warp leaves the wait together
      wgmma_fence();
      dx_box_product(ap, ad, ring + s * DX_BOX_BYTES + wg * TC_A_BLOCK, q,
                     wts);
      wgmma_commit();
      if (q > 0) {
        wgmma_wait<1>();
        mbar_arrive(empty + 8 * ((it - 1) % DX_STAGES));
      }
    }
    wgmma_wait0();
    mbar_arrive(empty + 8 * ((it - 1) % DX_STAGES));
    // register 4 j + 2 h + c: row 16 warp + lane / 4 + 8 h, column 8 j +
    // 2 (lane % 4) + c
    const int r0 = warp * 16 + lane / 4, q0 = 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = st + (r0 + 8 * h) * DX_ST + q0;
#pragma unroll
      for (int j = 0; j < PE_POS / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(ap[4 * j + 2 * h], ap[4 * j + 2 * h + 1]);
#pragma unroll
      for (int j = 0; j < PE_DIR / 8; ++j)
        *reinterpret_cast<float2*>(row + PE_POS + 8 * j) =
            make_float2(ad[4 * j + 2 * h], ad[4 * j + 2 * h + 1]);
    }
    dx_wg_sync(wg);
    // dx[r, c] = sum_f 2^f (dpe[sin_f, c] cos(2^f x) - dpe[cos_f, c]
    // sin(2^f x)), f = 0 up (dpe_d's columns 64.. for the direction)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = ct + 64 * k, r = i / 3;
      const float* dp = st + r * DX_ST + (dir ? PE_POS : 0) + i % 3;
      float g = 0.f;
      for (int f = 0; f < n_freq; ++f) {
        const float sc = (float)(1 << f);
        float sn, cs;
        sincosf(xv[k] * sc, &sn, &cs);
        g += sc * (dp[6 * f] * cs - dp[6 * f + 3] * sn);
      }
      dx[e0 + r * IN_PAD + c0 + i % 3] = g;
    }
    if (dir)  // the zero columns
      *reinterpret_cast<float2*>(dx + e0 + ct * IN_PAD + 6) =
          make_float2(0.f, 0.f);
    dx_wg_sync(wg);  // the staging rows are read before the next tile
  }
}

// ---------------------------------------------------------------------------
// fp32: K3 as 3xTF32 products on wgmma
// ---------------------------------------------------------------------------
//
// nerf_fwd_tf32_kernel (`nerf_mlp_fwd_tf32`) computes K3's function, x [N,
// 8] -> out [N, 8] with no activations kept, to fp32 accuracy: every
// product of the trunk and the view branch as three tf32 tensor-core
// products (tile_mm.cuh, "tf32 on wgmma"), the heads in fp32 on the CUDA
// cores.  It replaces no TPU kernel: the JAX package renders with the
// plain models, and this is the port's route for the same function
// (models/nerf.py takes it for every CUDA fp32 forward of the PE model that
// autograd does not record: the view renders).
//
// Design (the layout of film_mlp.cu's fp32 K8, for NeRF's products):
// persistent CTAs, one per SM, walk 64-point tiles.  A tile's activations
// sit in shared memory as K-major big and small halves (128 KB,
// nt_a_offset).  A producer thread streams the weight stack
// (ops/kernels/nerf_mlp.py::tf32_stack: per product, in nt_slices' order,
// and per K-slice of 32, the slice of W^T rounded to tf32, then its
// remainder, each a [N, 32] block of N = 256 or 128 rows: one TMA box)
// through a ring of NT_STAGES 32 KB stages.  Two consumer warpgroups split
// the N output columns (wgmma.m64n128k8, m64n64k8 in the view branch); per
// K-slice the big stage gives small(A) big(W) + big(A) big(W), the small
// stage big(A) small(W).  The epilogues add the bias and take the relu on
// the accumulator registers, and write h back into A as its big and small
// halves once both warpgroups' products have retired.  The PEs are
// computed on the CUDA cores (accurate sincosf, no fast math: the
// arguments reach ~3,000 rad) into A's first columns: e_pos before W0 and
// again, from the registers that kept its values, once h4 W5b has retired
// (h5 = h4 W5b + e_pos W5a into one accumulator; the ring and A leave no
// shared memory for a resident copy), e_dir once hd W9a has.  sigma (from
// the unrounded h7) and rgb (from h9) are fp32 sums on the CUDA cores;
// warpgroup 1's partial sums reach warpgroup 0 through shared memory.  No
// atomics: two launches are bitwise equal.
//
// What bounds it on an H100: per point 593,920 MACs on the tensor cores
// (the padded products), three times over in tf32: ~7.6 / ~22.6 ms at a
// view tile's 1,048,576 / 3,145,728 points at 494.7 TFLOP/s (FMA on the
// CUDA cores at 67 TFLOP/s: ~18.6 / ~55.9 ms).  Each 64-point tile streams
// 4.75 MB of weights from L2, which K8's measurements put near the same
// bound, so the epilogues are short (bias, relu, the tf32 split) and the
// ring runs on across products and tiles.

constexpr int NT_STAGES = 3;
constexpr int NT_KS = 32;                        // K per stage: 128 B of fp32
constexpr int NT_STAGE_BYTES = HID * NT_KS * 4;  // 32768: 256 columns x 32 K
constexpr int NT_TILE = 64;                      // points per CTA
constexpr int NT_A_BLOCK = NT_TILE * NT_KS * 4;  // 8192: 64 points x 32 K
constexpr int NT_A_BYTES = HID / NT_KS * NT_A_BLOCK;  // 65536: one half of A
constexpr int NT_CONSUMERS = 2 * TC_WG;
// and a producer warpgroup (one thread issues the TMA loads), so that
// setmaxnreg can move registers to the consumers
constexpr int NT_THREADS = NT_CONSUMERS + 128;
constexpr int NT_NACC = HID / 2 / 2;             // a warpgroup's accumulators
// the kernel's own region: warpgroup 1's partial head sums, [64][4]
constexpr int NT_HEADS_BYTES = NT_TILE * 4 * 4;
// [1024-aligned ring | A big | A small | head sums | full, empty barriers]
constexpr size_t NT_SMEM = 1024 + (size_t)NT_STAGES * NT_STAGE_BYTES
                           + 2 * (size_t)NT_A_BYTES + NT_HEADS_BYTES
                           + 2 * NT_STAGES * 8;
static_assert(NT_SMEM <= 232448, "the fp32 NeRF forward exceeds shared memory");
// The epilogues walk the accumulators in blocks of NT_JB steps of j.
constexpr int NT_JB = 8;

// The stream's products in order (nerf_mlp.py's TF32_SCHEDULE): W0, W1..W4,
// W5b, W5a, W6, W7, W8, W9a, W9b; product p's K-slices and output columns.
constexpr int NT_PRODUCTS = 12;
__host__ __device__ constexpr int nt_slices(int p) {
  return p == 0 || p == 6 ? PE_POS / NT_KS
                          : (p == 11 ? PE_DIR / NT_KS : HID / NT_KS);
}
__host__ __device__ constexpr int nt_cols(int p) {
  return p < 10 ? HID : RGB_HID;
}
constexpr int nt_stack_rows() {
  int rows = 0;
  for (int p = 0; p < NT_PRODUCTS; ++p) rows += 2 * nt_slices(p) * nt_cols(p);
  return rows;
}
constexpr int NT_STACK_ROWS = nt_stack_rows();  // 37,120: 4.75 MB
static_assert(NT_STACK_ROWS == 37120, "the tf32 stack's rows");

// A's byte offset (in either half) of (point p, column col): the 32-column
// block, then the point's 128-byte row with its 16-byte chunks permuted by
// the 128-byte swizzle
__device__ __forceinline__ int nt_a_offset(int p, int col) {
  return (col >> 5) * NT_A_BLOCK + p * 128 + ((((col >> 2) ^ p) & 7) << 4)
         + (col & 3) * 4;
}

struct NtCtx {
  uint32_t ring, bars;  // shared addresses: the ring; full, then empty
  uint32_t a;           // A's big half; its small half follows
  unsigned char* ag;    // ... and its generic pointer
  float* heads;         // warpgroup 1's partial head sums
  int it;               // ring stages consumed so far
  int wg, warp, lane, tid;
};

// The two consumer warpgroups' barrier (named barrier 1).
__device__ __forceinline__ void nt_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT_CONSUMERS) : "memory");
}

// v -> A's big and small halves at (point p, column col).
__device__ __forceinline__ void nt_store(const NtCtx& c, int p, int col,
                                         float v) {
  const float big = tf32_big(v);
  const int off = nt_a_offset(p, col);
  *reinterpret_cast<float*>(c.ag + off) = big;
  *reinterpret_cast<float*>(c.ag + NT_A_BYTES + off) = __fsub_rn(v, big);
}

// A positional encoding of the tile (x rows at xt), interleaved [sin_f(3),
// cos_f(3)] per frequency f as fwd_pe computes it, zero-padded: e_pos
// (POS, 10 frequencies, A's columns 0..63) or e_dir (4, columns 0..31).
// Both warpgroups share it: (point, frequency, dimension) i = t +
// NT_CONSUMERS k is thread t's k-th, its sine and cosine v[2 k], v[2 k + 1].
template <bool POS> struct NtPe {
  static constexpr int NF = POS ? 10 : 4, NQ = 3 * NF;
  static constexpr int IT = (NT_TILE * NQ + NT_CONSUMERS - 1) / NT_CONSUMERS;
  static constexpr int PAD = (POS ? PE_POS : PE_DIR) - 6 * NF;
};

// This thread's values of the encoding (accurate sincosf: the arguments
// reach ~3,000 rad).
template <bool POS>
__device__ __forceinline__ void nt_pe_values(
    const NtCtx& c, const float* xt, float (&v)[2 * NtPe<POS>::IT]) {
  using E = NtPe<POS>;
  const int t = c.wg * TC_WG + c.tid;
#pragma unroll
  for (int k = 0; k < E::IT; ++k) {
    const int i = t + NT_CONSUMERS * k, r = i / E::NQ, q = i % E::NQ;
    const int f = q / 3, d = q % 3;
    if (i < NT_TILE * E::NQ)
      sincosf(__ldg(xt + r * IN_PAD + (POS ? d : 3 + d)) * (float)(1 << f),
              &v[2 * k], &v[2 * k + 1]);
  }
}

// The values into A's big and small halves, with the padding's zeros.
// Ends with A visible to the next wgmma.
template <bool POS>
__device__ __forceinline__ void nt_pe_store(
    const NtCtx& c, const float (&v)[2 * NtPe<POS>::IT]) {
  using E = NtPe<POS>;
  const int t = c.wg * TC_WG + c.tid;
#pragma unroll
  for (int k = 0; k < E::IT; ++k) {
    const int i = t + NT_CONSUMERS * k, r = i / E::NQ, q = i % E::NQ;
    const int col = 6 * (q / 3) + q % 3;
    if (i < NT_TILE * E::NQ) {
      nt_store(c, r, col, v[2 * k]);
      nt_store(c, r, col + 3, v[2 * k + 1]);
    }
  }
  for (int i = t; i < NT_TILE * E::PAD; i += NT_CONSUMERS)
    nt_store(c, i / E::PAD, 6 * E::NF + i % E::PAD, 0.f);
  fence_proxy_async();
  nt_sync();
}

// One ring stage's wgmmas on this warpgroup's NW columns (rows NW wg.. of
// the stage) for the K-slice whose A blocks start at shared address a: the
// big stage (BIG) small(A) big(W) + big(A) big(W), the small stage big(A)
// small(W).  zero: the product's first stage, which starts from zero;
// release: the previous stage's wgmmas are waited for and the stage
// released.  Each stage's wgmmas follow their own wgmma.fence, as in K8.
template <int NW, bool BIG>
__device__ __forceinline__ void nt_stage(NtCtx& c, float* acc, uint32_t a,
                                         bool zero, bool release) {
  const int st = c.it % NT_STAGES;
  mbar_wait(c.bars + 8 * st, (c.it / NT_STAGES) & 1);
  __syncwarp();  // wgmma is .aligned
  const uint32_t b = c.ring + st * NT_STAGE_BYTES + c.wg * NW * 128;
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < NT_KS / 8; ++k) {
    const uint64_t db = gmma_desc(b + k * 32, TC_A_LBO, TC_A_SBO);
    const uint64_t big = gmma_desc(a + k * 32, TC_A_LBO, TC_A_SBO);
    if constexpr (NW == HID / 2) {
      if constexpr (BIG)
        wgmma_m64n128k8_tf32(acc, gmma_desc(a + NT_A_BYTES + k * 32, TC_A_LBO,
                                            TC_A_SBO), db, !zero || k > 0);
      wgmma_m64n128k8_tf32(acc, big, db, 1);
    } else {
      if constexpr (BIG)
        wgmma_m64n64k8_tf32(acc, gmma_desc(a + NT_A_BYTES + k * 32, TC_A_LBO,
                                           TC_A_SBO), db, !zero || k > 0);
      wgmma_m64n64k8_tf32(acc, big, db, 1);
    }
  }
  wgmma_commit();
  if (release) {
    wgmma_wait<1>();  // the previous stage's wgmmas have retired
    mbar_arrive(c.bars + 8 * (NT_STAGES + (c.it - 1) % NT_STAGES));
  }
  ++c.it;
}

// acc (+)= A W over the next 2 SLICES ring stages, A's K-slices from A's
// block 0 (one product of NW columns per warpgroup); accumulate = false
// starts from zero.  Ends with this warpgroup's wgmmas retired and every
// stage released; the other warpgroup may still read A.
template <int NW, int SLICES>
__device__ __forceinline__ void nt_product(NtCtx& c, float* acc,
                                           bool accumulate) {
#pragma unroll 1
  for (int ks = 0; ks < SLICES; ++ks) {
    const uint32_t a = c.a + ks * NT_A_BLOCK;
    nt_stage<NW, true>(c, acc, a, !accumulate && ks == 0, ks > 0);
    nt_stage<NW, false>(c, acc, a, false, true);
  }
  wgmma_wait0();
  mbar_arrive(c.bars + 8 * (NT_STAGES + (c.it - 1) % NT_STAGES));
}

// What an epilogue does besides bias and relu (compile-time, so the walk
// has no branches to schedule around); nerf_fwd_tc_kernel's EPI_* kinds.
// Epilogue of a layer on this warpgroup's NW columns: h = acc + b, relu
// unless EPI_LINEAR; h -> A's big and small halves unless EPI_RGB (h9 feeds
// only the head); hs[h][q] = this warpgroup's part of row r0 + 8 h's h .
// Wh[:, q] (q < NH: sigma with EPI_SIGMA, rgb with EPI_RGB), summed over
// the 4 lanes of a row.
template <int NW, int KIND>
__device__ __forceinline__ void nt_epi(const NtCtx& c, const float* acc,
                                       const float* bias, const float* wh,
                                       float (&hs)[2][3]) {
  constexpr bool RELU = !(KIND & EPI_LINEAR), TO_A = !(KIND & EPI_RGB);
  constexpr int NH = (KIND & EPI_RGB) ? 3 : ((KIND & EPI_SIGMA) ? 1 : 0);
  static_assert(NW / 8 % NT_JB == 0, "whole blocks of the walk");
  const int r0 = c.warp * 16 + c.lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 3; ++q) hs[h][q] = 0.f;
#pragma unroll 1
  for (int jb = 0; jb < NW / 8; jb += NT_JB) {
    float a[4 * NT_JB];
    acc_block<NT_JB, NT_NACC>(acc, jb, a);
#pragma unroll
    for (int jj = 0; jj < NT_JB; ++jj) {
      const int col = c.wg * NW + 8 * (jb + jj) + 2 * (c.lane % 4);
      const float2 bc = ld2(bias + col);
      float whc[2][3];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
#pragma unroll
        for (int q = 0; q < NH; ++q)
          whc[cc][q] = __ldg(wh + (col + cc) * OUT_PAD + q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fadd_rn(a[4 * jj + 2 * h], bc.x);
        float v1 = __fadd_rn(a[4 * jj + 2 * h + 1], bc.y);
        if constexpr (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if constexpr (TO_A) {
          const float2 big = make_float2(tf32_big(v0), tf32_big(v1));
          const int off = nt_a_offset(r0 + 8 * h, col);
          *reinterpret_cast<float2*>(c.ag + off) = big;
          *reinterpret_cast<float2*>(c.ag + NT_A_BYTES + off) =
              make_float2(__fsub_rn(v0, big.x), __fsub_rn(v1, big.y));
        }
#pragma unroll
        for (int q = 0; q < NH; ++q)
          hs[h][q] += v0 * whc[0][q] + v1 * whc[1][q];
      }
    }
  }
  if constexpr (NH > 0) {
    // a row's NW columns of this warpgroup lie in the 4 lanes that share
    // lane / 4
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < NH; ++q)
#pragma unroll
        for (int o = 1; o < 4; o <<= 1)
          hs[h][q] += __shfl_xor_sync(0xffffffffu, hs[h][q], o);
  }
}

// The producer's one thread: the stack's products for each of this
// CTA's `tiles` tiles, each K-slice's big block then its small one, into
// the ring (map256 for the 256-row blocks, map128 for the 128-row ones).
__device__ __forceinline__ void nt_produce(uint32_t ring, uint32_t bars,
                                           const CUtensorMap* map256,
                                           const CUtensorMap* map128,
                                           int tiles) {
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    int row = 0;
    for (int p = 0; p < NT_PRODUCTS; ++p) {
      const int n = nt_cols(p);
      for (int s = 0; s < 2 * nt_slices(p); ++s, ++it, row += n) {
        const int st = it % NT_STAGES;
        mbar_wait(bars + 8 * (NT_STAGES + st), ((it / NT_STAGES) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * st, n * NT_KS * 4);
        tma_load_2d(ring + st * NT_STAGE_BYTES, n == HID ? map256 : map128, 0,
                    row, bars + 8 * st);
      }
    }
  }
}

// grid min(tiles, SMs), each CTA the tiles blockIdx.x + k gridDim.x; x and
// out [n, 8]; map256 / map128 over the tf32 stack ([NT_STACK_ROWS, 32]
// fp32) with boxes of 256 / 128 rows.
__global__ void __launch_bounds__(NT_THREADS, 1)
nerf_fwd_tf32_kernel(const __grid_constant__ CUtensorMap map256,
                     const __grid_constant__ CUtensorMap map128,
                     const float* __restrict__ x, Params P,
                     float* __restrict__ out, int n_tiles) {
  extern __shared__ unsigned char nt_smem_raw[];
  const uint32_t raw = smem_u32(nt_smem_raw);
  NtCtx c;
  c.ring = (raw + 1023) & ~1023u;
  c.a = c.ring + NT_STAGES * NT_STAGE_BYTES;
  c.ag = nt_smem_raw + (c.a - raw);
  c.heads = reinterpret_cast<float*>(c.ag + 2 * NT_A_BYTES);
  c.bars = c.a + 2 * NT_A_BYTES + NT_HEADS_BYTES;
  c.it = 0;
  c.wg = threadIdx.x / TC_WG;
  c.tid = threadIdx.x % TC_WG;
  c.warp = c.tid / 32;
  c.lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NT_STAGES; ++s) {
      mbar_init(c.bars + 8 * s, 1);
      mbar_init(c.bars + 8 * (NT_STAGES + s), NT_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= NT_CONSUMERS) {
    tc_regs_producer();
    if (threadIdx.x == NT_CONSUMERS) {
      const int mine = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
      nt_produce(c.ring, c.bars, &map256, &map128, mine);
    }
    return;
  }
  tc_regs_consumer();
  auto Bv = [&](int i) { return reinterpret_cast<const float*>(P.p[i]); };
  constexpr int NW = HID / 2, NWD = RGB_HID / 2;
  const int r0 = c.warp * 16 + c.lane / 4;
  float acc[NT_NACC], sig[2][3], rgb[2][3], none[2][3];
  // e_pos, computed once per tile and kept for W5a; e_dir
  float pe_pos[2 * NtPe<true>::IT], pe_dir[2 * NtPe<false>::IT];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * NT_TILE;
    const float* xt = x + row0 * IN_PAD;
    nt_pe_values<true>(c, xt, pe_pos);
    nt_pe_store<true>(c, pe_pos);  // also: both warpgroups are done with A
    nt_product<NW, PE_POS / NT_KS>(c, acc, false);  // h0 = relu(e_pos W0 + b0)
    nt_sync();  // both warpgroups are done reading A
    nt_epi<NW, 0>(c, acc, Bv(B0), nullptr, none);
    for (int l = 1; l < 5; ++l) {  // h1..h4
      fence_proxy_async();  // A's new values, for the other warpgroup too
      nt_sync();
      nt_product<NW, HID / NT_KS>(c, acc, false);
      nt_sync();
      nt_epi<NW, 0>(c, acc, Bv(B0 + 2 * l), nullptr, none);
    }
    fence_proxy_async();  // h5 = relu(h4 W5b + e_pos W5a + b5)
    nt_sync();
    nt_product<NW, HID / NT_KS>(c, acc, false);
    nt_sync();
    nt_pe_store<true>(c, pe_pos);
    nt_product<NW, PE_POS / NT_KS>(c, acc, true);
    nt_sync();
    nt_epi<NW, 0>(c, acc, Bv(B5), nullptr, none);
    fence_proxy_async();  // h6
    nt_sync();
    nt_product<NW, HID / NT_KS>(c, acc, false);
    nt_sync();
    nt_epi<NW, 0>(c, acc, Bv(B6), nullptr, none);
    fence_proxy_async();  // h7, and sigma's part from it
    nt_sync();
    nt_product<NW, HID / NT_KS>(c, acc, false);
    nt_sync();
    nt_epi<NW, EPI_SIGMA>(c, acc, Bv(B7), Bv(WS), sig);
    fence_proxy_async();  // hd = h7 W8 + b8 (linear)
    nt_sync();
    nt_product<NW, HID / NT_KS>(c, acc, false);
    nt_sync();
    nt_epi<NW, EPI_LINEAR>(c, acc, Bv(B8), nullptr, none);
    fence_proxy_async();  // h9 = relu(hd W9a + e_dir W9b + b9), 64 columns each
    nt_sync();
    nt_product<NWD, HID / NT_KS>(c, acc, false);
    nt_sync();
    nt_pe_values<false>(c, xt, pe_dir);
    nt_pe_store<false>(c, pe_dir);
    nt_product<NWD, PE_DIR / NT_KS>(c, acc, true);
    nt_epi<NWD, EPI_RGB>(c, acc, Bv(B9), Bv(WR), rgb);
    if (c.wg == 1 && c.lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(c.heads + (r0 + 8 * h) * 4) =
            make_float4(rgb[h][0], rgb[h][1], rgb[h][2], sig[h][0]);
    }
    nt_sync();  // also: both warpgroups are done reading A
    if (c.wg == 0 && c.lane % 4 == 0) {
      const float *bs = Bv(BS), *br = Bv(BR);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float4 o = *reinterpret_cast<const float4*>(c.heads + r * 4);
        float4* dst = reinterpret_cast<float4*>(out + (row0 + r) * OUT_PAD);
        dst[0] = make_float4(1.f / (1.f + expf(-(rgb[h][0] + o.x + br[0]))),
                             1.f / (1.f + expf(-(rgb[h][1] + o.y + br[1]))),
                             1.f / (1.f + expf(-(rgb[h][2] + o.z + br[2]))),
                             fmaxf(sig[h][0] + o.w + bs[0], 0.f));
        dst[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// fp32 K1 (SPILL) and K3
template <bool SPILL>
int fwd_launch(const float* x, const Params& P, float* out, void* acts,
               int n, cudaStream_t st) {
  constexpr int TM = 32;
  auto kern = fwd_kernel<float, TM, SPILL>;
  constexpr size_t sm = fwd_smem<float, TM, 1>();
  cudaError_t e = set_smem(kern, sm);
  if (e != cudaSuccess) return (int)e;
  kern<<<n / TM, THREADS, sm, st>>>(x, P, out, reinterpret_cast<float*>(acts));
  return (int)cudaGetLastError();
}

// fp32 K6
int fwd_pipelined_launch(const float* x, const Params& P, float* out, int n,
                         cudaStream_t st) {
  constexpr int TM = 16;
  auto kern = fwd_pipelined_kernel<float, TM>;
  constexpr size_t sm = fwd_smem<float, TM, 2>();
  static_assert(sm <= 232448, "K6 exceeds a block's shared memory");
  cudaError_t e = set_smem(kern, sm);
  if (e != cudaSuccess) return (int)e;
  kern<<<n / TM, THREADS, sm, st>>>(x, P, out);
  return (int)cudaGetLastError();
}

// bf16 K1 (acts given: the spill), K3, K6 and K5's recompute: the forward
// over n points (x rows) into out (unless null), streaming wstack.
int fwd_tc_launch(const float* x, const Params& P, const void* wstack,
                  float* out, void* acts, int n, cudaStream_t st) {
  CUtensorMap wmap, amap{};
  cudaError_t e = make_map(&wmap, wstack, HID, NF_STAGES * KS);
  if (e == cudaSuccess && acts) e = make_map(&amap, acts, ACT_PAD, n);
  auto kern = acts ? nerf_fwd_tc_kernel<true> : nerf_fwd_tc_kernel<false>;
  if (e == cudaSuccess) e = set_smem(kern, NF_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = n / TC_TILE;
  kern<<<(n_tiles + 1) / 2, TC_THREADS, NF_SMEM, st>>>(
      wmap, amap, x, P, out, reinterpret_cast<bf16_t*>(acts), n_tiles);
  return (int)cudaGetLastError();
}

// The delta chain over n points: deltas [n, DELTA_W] from dy [n, 8] and the
// spill acts [n, ACT_PAD]; bf16 streams wstack and, when pe_out is given,
// also writes dh9 | dh5 | dh0 to pe_out's rows pe_row0.. (pe_rows rows).
int deltas_launch(const Params& P, const void* wstack, const float* dy,
                  const void* acts, void* deltas, int n, void* pe_out,
                  int pe_rows, int pe_row0, int bf16, cudaStream_t st) {
  if (!bf16) {
    constexpr int TM = 32;
    auto kd = bwd_delta_kernel<float, TM>;
    constexpr size_t smd = delta_smem<float, TM>();
    cudaError_t e = set_smem(kd, smd);
    if (e != cudaSuccess) return (int)e;
    kd<<<n / TM, THREADS, smd, st>>>(P, dy,
                                     reinterpret_cast<const float*>(acts),
                                     reinterpret_cast<float*>(deltas));
    return (int)cudaGetLastError();
  }
  CUtensorMap wmap, amap, dmap, pmap{};
  cudaError_t e = make_map(&wmap, wstack, HID, NB_STAGES * KS);
  if (e == cudaSuccess) e = make_map(&amap, acts, ACT_PAD, n);
  if (e == cudaSuccess) e = make_map(&dmap, deltas, DELTA_W, n);
  if (e == cudaSuccess && pe_out) e = make_map(&pmap, pe_out, PE_DW, pe_rows);
  if (e == cudaSuccess) e = set_smem(nerf_bwd_delta_tc_kernel, NB_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = n / TC_TILE;
  nerf_bwd_delta_tc_kernel<<<(n_tiles + 1) / 2, TC_THREADS, NB_SMEM, st>>>(
      wmap, amap, dmap, pmap, P, dy, reinterpret_cast<bf16_t*>(deltas),
      n_tiles, pe_out ? pe_row0 : -1);
  return (int)cudaGetLastError();
}

// K5: chunks of chunk_rows points (whole splits of cps * PK points each,
// the last chunk the rest); for each, tile(r0, rows) launches the per-tile
// work into the acts and deltas workspaces, then the chunk's splits'
// partials; then one sum over all `splits`.
template <typename T, typename F>
int bwd_chunks(F tile, const void* acts, const void* deltas, int chunk_rows,
               float* partials, float* dw, int n, int splits, const Tasks& tk,
               int total, cudaStream_t st) {
  const int cps = chunks_per_split(n, splits), per_split = cps * PK;
  if (chunk_rows < 1
      || (chunk_rows < n && (chunk_rows % per_split || chunk_rows % 128)))
    return (int)cudaErrorInvalidValue;
  for (int r0 = 0; r0 < n; r0 += chunk_rows) {
    const int rows = min(chunk_rows, n - r0);
    int e = tile(r0, rows);
    if (e) return e;
    const int s0 = r0 / per_split;
    const int ns = r0 + rows < n ? rows / per_split : splits - s0;
    e = (int)dw_partials<T>(reinterpret_cast<const T*>(acts), ACT_PAD,
                            reinterpret_cast<const T*>(deltas), DELTA_W,
                            partials + (size_t)s0 * total, rows, ns, cps, tk,
                            total, st);
    if (e) return e;
  }
  return (int)sum_splits(partials, dw, total, splits, 0, st);
}

// fp32 K4: one CTA per DX_TM points
int dx_launch(const float* x, const Params& P, const void* dh9,
              const void* dh5, const void* dh0, int ld, float* dx, int n,
              cudaStream_t st) {
  cudaError_t e = set_smem(dx_kernel, DX_SMEM);
  if (e != cudaSuccess) return (int)e;
  dx_kernel<<<n / DX_TM, THREADS, DX_SMEM, st>>>(
      x, P, reinterpret_cast<const float*>(dh9),
      reinterpret_cast<const float*>(dh5),
      reinterpret_cast<const float*>(dh0), ld, dx);
  return (int)cudaGetLastError();
}

// bf16 K4: dx_tc_kernel over n / DX_TILE tiles on min(SMs, tiles) CTAs.
int dx_tc_launch(const float* x, const Params& P, const void* dh9,
                 const void* dh5, const void* dh0, int ld, float* dx, int n,
                 cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  CUtensorMap w5a, w0, w9b, m5, m0, m9;
  if (e == cudaSuccess)
    e = make_view_map(&w5a, P.p[W5A], HID, HID, PE_POS, PE_POS);
  if (e == cudaSuccess)
    e = make_view_map(&w0, P.p[W0], HID, HID, PE_POS, PE_POS);
  if (e == cudaSuccess)
    e = make_view_map(&w9b, P.p[W9B], RGB_HID, RGB_HID, PE_DIR, PE_DIR);
  if (e == cudaSuccess) e = make_view_map(&m5, dh5, HID, ld, n, DX_TILE);
  if (e == cudaSuccess) e = make_view_map(&m0, dh0, HID, ld, n, DX_TILE);
  if (e == cudaSuccess) e = make_view_map(&m9, dh9, RGB_HID, ld, n, DX_TILE);
  if (e == cudaSuccess) e = set_smem(dx_tc_kernel, DX_TC_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = n / DX_TILE;
  dx_tc_kernel<<<min(sms, n_tiles), DX_THREADS, DX_TC_SMEM, st>>>(
      w5a, w0, w9b, m5, m0, m9, x, dx, n_tiles);
  return (int)cudaGetLastError();
}

// The tensor map of the tf32 stack ([NT_STACK_ROWS, 32] fp32, 128-byte
// rows) with boxes of box_rows rows and 128-byte swizzle: one ring stage,
// or half of one, per box.
cudaError_t make_map_tf32(CUtensorMap* map, const void* ptr, int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)NT_KS, (cuuint64_t)NT_STACK_ROWS};
  const cuuint64_t strides[1] = {(cuuint64_t)NT_KS * sizeof(float)};
  const cuuint32_t box[2] = {NT_KS, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// fp32 K3 as 3xTF32: nerf_fwd_tf32_kernel over n / NT_TILE tiles on
// min(SMs, tiles) CTAs.
int fwd_tf32_launch(const float* x, const Params& P, const void* wstack,
                    float* out, int n, cudaStream_t st) {
  int dev = 0, sms = 0;
  CUtensorMap map256, map128;
  cudaError_t e = make_map_tf32(&map256, wstack, HID);
  if (e == cudaSuccess) e = make_map_tf32(&map128, wstack, RGB_HID);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = set_smem(nerf_fwd_tf32_kernel, NT_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = n / NT_TILE;
  nerf_fwd_tf32_kernel<<<min(sms, n_tiles), NT_THREADS, NT_SMEM, st>>>(
      map256, map128, x, P, out, n_tiles);
  return (int)cudaGetLastError();
}

Params make_params(const void* const* w) {
  Params P;
  for (int i = 0; i < N_PARAMS; ++i) P.p[i] = w[i];
  return P;
}

}  // namespace

// K1: out [n, 8] and the activation spill [n, ACT_PAD]; bf16 also takes the
// forward weight stack ([2464, 256] bf16).
extern "C" int nerf_mlp_fwd_save(const float* x, const void* const* w,
                                 const void* wstack, float* out, void* acts,
                                 int n, int bf16, void* stream) {
  if (n % 128 || (bf16 && !wstack)) return (int)cudaErrorInvalidValue;
  const Params P = make_params(w);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? fwd_tc_launch(x, P, wstack, out, acts, n, st)
              : fwd_launch<true>(x, P, out, acts, n, st);
}

// K3 (pipe = 0) or K6 (pipe = 1): out [n, 8].  In bf16 both are the same
// kernel, its two warpgroups K6's two chains.
extern "C" int nerf_mlp_fwd(const float* x, const void* const* w,
                            const void* wstack, float* out, int n, int pipe,
                            int bf16, void* stream) {
  if (n % 128 || (bf16 && !wstack)) return (int)cudaErrorInvalidValue;
  const Params P = make_params(w);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) return fwd_tc_launch(x, P, wstack, out, nullptr, n, st);
  return pipe ? fwd_pipelined_launch(x, P, out, n, st)
              : fwd_launch<false>(x, P, out, nullptr, n, st);
}

// K3 in fp32 as 3xTF32 products on wgmma: out [n, 8] from x [n, 8], the
// packed fp32 weights (biases and heads) and the tf32 stack ([37120, 32]
// fp32: nerf_mlp.py's tf32_stack).
extern "C" int nerf_mlp_fwd_tf32(const float* x, const void* const* w,
                                 const void* wstack, float* out, int n,
                                 void* stream) {
  if (n % 128 || n < 1 || !wstack) return (int)cudaErrorInvalidValue;
  return fwd_tf32_launch(x, make_params(w), wstack, out, n,
                         reinterpret_cast<cudaStream_t>(stream));
}

// K2's delta chain alone (its part (a)): deltas [n, DELTA_W] from dy [n, 8]
// and the spill; bf16 also takes the backward weight stack ([2176, 256]).
extern "C" int nerf_mlp_deltas(const void* const* w, const void* wstack,
                               const float* dy, const void* acts,
                               void* deltas, int n, int bf16, void* stream) {
  if (n % 128 || (bf16 && !wstack)) return (int)cudaErrorInvalidValue;
  return deltas_launch(make_params(w), wstack, dy, acts, deltas, n, nullptr,
                       0, 0, bf16, reinterpret_cast<cudaStream_t>(stream));
}

// K2: the packed gradients into dw from dy [n, 8] and the spill; deltas
// [n, DELTA_W] is its workspace (and K4's input), partials [splits, total];
// bf16 also takes the backward weight stack.
extern "C" int nerf_mlp_bwd_saved(const void* const* w, const void* wstack,
                                  const float* dy, const void* acts,
                                  void* deltas, float* partials, float* dw,
                                  int n, int splits, const int* tasks,
                                  int n_tasks, int bf16, void* stream) {
  if (n % 128 || n_tasks > MAX_TASKS || splits < 1 || (bf16 && !wstack))
    return (int)cudaErrorInvalidValue;
  Tasks tk;
  const int total = make_tasks(tasks, n_tasks, tk);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int e = deltas_launch(make_params(w), wstack, dy, acts, deltas, n,
                              nullptr, 0, 0, bf16, st);
  if (e) return e;
  return bf16 ? (int)dw_splitk<bf16_t>(
                    reinterpret_cast<const bf16_t*>(acts), ACT_PAD,
                    reinterpret_cast<const bf16_t*>(deltas), DELTA_W,
                    partials, dw, n, splits, tk, total, 0, st)
              : (int)dw_splitk<float>(
                    reinterpret_cast<const float*>(acts), ACT_PAD,
                    reinterpret_cast<const float*>(deltas), DELTA_W,
                    partials, dw, n, splits, tk, total, 0, st);
}

// K5: the packed gradients into dw from x and dy [n, 8].  acts
// [chunk_rows, ACT_PAD] and deltas [chunk_rows, DELTA_W] are its
// workspaces, partials [splits, total]; chunk_rows is a multiple of 128 and
// of a split's points.  pe_out ([n, 640]: dh9 | dh5 | dh0, K4's input) may
// be null.  bf16 also takes both weight stacks: per chunk K1's forward
// kernel (the spill into acts), then K2's delta kernel.
extern "C" int nerf_mlp_bwd(const float* x, const void* const* w,
                            const void* wstack_fwd, const void* wstack_bwd,
                            const float* dy, void* acts, void* deltas,
                            int chunk_rows, void* pe_out, float* partials,
                            float* dw, int n, int splits, const int* tasks,
                            int n_tasks, int bf16, void* stream) {
  if (n % 128 || n_tasks > MAX_TASKS || splits < 1
      || (bf16 && !(wstack_fwd && wstack_bwd)))
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(w);
  Tasks tk;
  const int total = make_tasks(tasks, n_tasks, tk);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    auto tile = [&](int r0, int rows) {
      const int e = fwd_tc_launch(x + (size_t)r0 * IN_PAD, P, wstack_fwd,
                                  nullptr, acts, rows, st);
      if (e) return e;
      return deltas_launch(P, wstack_bwd, dy + (size_t)r0 * OUT_PAD, acts,
                           deltas, rows, pe_out, n, r0, 1, st);
    };
    return bwd_chunks<bf16_t>(tile, acts, deltas, chunk_rows, partials, dw,
                              n, splits, tk, total, st);
  }
  constexpr int TM = 32;
  auto kr = bwd_recompute_kernel<float, TM>;
  constexpr size_t sm = recompute_smem<float, TM>();
  const cudaError_t e = set_smem(kr, sm);
  if (e != cudaSuccess) return (int)e;
  float* po = reinterpret_cast<float*>(pe_out);
  auto tile = [&](int r0, int rows) {
    kr<<<rows / TM, THREADS, sm, st>>>(
        x + (size_t)r0 * IN_PAD, P, dy + (size_t)r0 * OUT_PAD,
        reinterpret_cast<float*>(acts), reinterpret_cast<float*>(deltas),
        po ? po + (size_t)r0 * PE_DW : nullptr);
    return (int)cudaGetLastError();
  };
  return bwd_chunks<float>(tile, acts, deltas, chunk_rows, partials, dw, n,
                           splits, tk, total, st);
}

// K4: dx [n, 8] from x [n, 8] and the deltas dh9 [n, 128], dh5 and dh0
// [n, 256], rows ld elements apart (16-byte aligned rows); n a multiple of
// 128.
extern "C" int nerf_mlp_dx(const float* x, const void* const* w,
                           const void* dh9, const void* dh5, const void* dh0,
                           int ld, float* dx, int n, int bf16, void* stream) {
  static_assert(DX_TM * IN_PAD == THREADS, "one thread per dx element");
  if (n % DX_TILE || ld < HID || ld % 8) return (int)cudaErrorInvalidValue;
  const Params P = make_params(w);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? dx_tc_launch(x, P, dh9, dh5, dh0, ld, dx, n, st)
              : dx_launch(x, P, dh9, dh5, dh0, ld, dx, n, st);
}
