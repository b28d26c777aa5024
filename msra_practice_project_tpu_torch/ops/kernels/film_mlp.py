"""Fused FiLM-SIREN trunk of the pi-GAN generator: the forward (K8) and the
recompute backward (K7).

Port of ``msra_practice_project_tpu/ops/pallas/film_mlp.py``: K8 replaces
``_fwd_kernel`` (launched by ``_fused_forward``), K7 replaces ``_bwd_kernel``
(launched by ``_fused_backward``).  The CUDA kernels are ``csrc/film_mlp.cu``;
the source notes there give the bound on an H100 and the design.

Each kernel has a plain PyTorch version here with the same ``bf16`` switch:
with ``bf16=True`` it rounds matmul operands to bf16 where the JAX kernel's
``_mm``/``_mmT``/``_mmB`` do, and K7 rounds the recomputed ``u_l``/``h_l``
where its ``store_bf16`` does (the film backward uses the rounded ``u``);
sums stay fp32.  With ``bf16=False`` everything is fp32.  A wrapper takes the
plain version only for tensors on the CPU; a CUDA tensor launches the kernel
or raises.

The trunk sine follows ``core.nn.USE_FAST_SIN`` (``MSRA_TPU_FAST_SIN``), read
at each call unless ``fast_sin`` is given: the polynomial by default, else
the exact sine (``torch.sin`` in the plain versions, the kernels' exact-sine
instantiations on the card, counted in ``launches_exact``).

Shapes (points per image padded to a multiple of ``PT_MULT``, zero rows):
  x ``[B, P, 8]`` = pos(3), dir(3), pad(2);  film ``[B, 9, 512]`` =
  gamma(256) || beta(256) per FiLM layer;  out and dy ``[B, P, 8]`` =
  rgb(3), sigma(1), zeros;  weights in ``PACK_KEYS`` order with the padded
  ``[in, out]`` shapes of ``pack_film_params``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...core import nn as core_nn
from ...core.nn import trunk_sin, trunk_sin_vjp
from . import dw_splitk as DW

IN_PAD = 8       # [pos(3), dir(3), pad(2)]
HID = 256
OUT_PAD = 8      # [rgb(3), sigma(1), pad(4)]
N_FILM = 9
W0_CONST = 30.0
PT_MULT = 64     # points per image: a multiple of every kernel's tile

PACK_KEYS = (["W0", "b0"]
             + [f"W{i}" for i in range(1, 8)]
             + [f"b{i}" for i in range(1, 8)]
             + ["W8a", "W8b", "b8", "Ws", "bs", "Wr", "br"])
_W_KEYS = frozenset(k for k in PACK_KEYS if k.startswith("W"))

PACK_SHAPES = {
    "W0": (IN_PAD, HID), "W8b": (IN_PAD, HID), "W8a": (HID, HID),
    "Ws": (HID, OUT_PAD), "Wr": (HID, OUT_PAD),
    "bs": (1, OUT_PAD), "br": (1, OUT_PAD), "b8": (1, HID),
    **{f"W{i}": (HID, HID) for i in range(1, 8)},
    **{f"b{i}": (1, HID) for i in range(8)},
}


def _offsets(slots):
    offs, o = {}, 0
    for name, w in slots:
        offs[name] = (o, o + w)
        o += w
    return offs, o


# K7's workspaces, one row per point (csrc/film_mlp.cu): acts
# [x(8) | h0..h8], u [u0..u8], deltas [dr(8) | dsig(8) | du0..du8]; one row
# of sums per tile: [l][dgamma | dbeta | db] for l = 0..8, dr(8), dsig(8).
ACT_OFFS, ACT_W = _offsets([("x", IN_PAD)]
                           + [(f"h{l}", HID) for l in range(N_FILM)])
U_W = N_FILM * HID
DELTA_OFFS, DELTA_W = _offsets([("dr", OUT_PAD), ("dsig", OUT_PAD)]
                               + [(f"du{l}", HID) for l in range(N_FILM)])
SUM_W = N_FILM * 3 * HID + 2 * OUT_PAD

# dW = act^T . delta per packed weight
GRAD_PAIRS = {"W0": ("x", "du0"), "W8a": ("h7", "du8"), "W8b": ("x", "du8"),
              "Ws": ("h7", "dsig"), "Wr": ("h8", "dr"),
              **{f"W{l}": (f"h{l - 1}", f"du{l}") for l in range(1, 8)}}
# K7's flat gradient: the weights (the split-K pass), then the biases (the
# per-tile sums), each in PACK_KEYS order.
GRAD_KEYS = ([k for k in PACK_KEYS if k in _W_KEYS]
             + [k for k in PACK_KEYS if k not in _W_KEYS])
GRAD_OFFS, GRAD_TOTAL = _offsets(
    [(k, PACK_SHAPES[k][0] * PACK_SHAPES[k][1]) for k in GRAD_KEYS])
BIAS_OFF = GRAD_OFFS["b0"][0]

# K7's scratch is bounded by running its passes over chunks of whole images.
SCRATCH_BYTES = 2 ** 31

# The fp32 K8 (csrc/film_mlp.cu, "fp32: K8 as 3xTF32 products on wgmma"): a
# CTA owns one TF_TILE-point tile; its activations are a big and a small
# half, each eight TF_A_BLOCK blocks of 64 points x 32 fp32 columns,
# 128-byte swizzled; the weights stream in stages of 32 K x 256 output
# columns of tf32_stack.
TF_TILE = 64
TF_A_BLOCK = TF_TILE * 32 * 4

# The bf16 per-tile pass (csrc/film_mlp.cu, "bf16: the per-tile pass on
# wgmma"): a CTA's two warpgroups own 64-point tiles 2 * cta and 2 * cta + 1
# and share one TMA stream of weight slices (TC_STAGE_BYTES each: 32 rows of
# a weight stack) through a ring of TC_STAGES; a warpgroup's activations are
# four TC_A_BLOCK blocks of 64 points x 64 columns, 128-byte swizzled.
TC_TILE = 64
TC_STAGES = 6
TC_STAGE_BYTES = 32 * HID * 2
TC_A_BLOCK = TC_TILE * 64 * 2


# ---------------------------------------------------------------------------
# Packing: FilmSirenNeRF parameters (torch layout, [out, in]) <-> the padded
# [in, out] arrays the kernels take
# ---------------------------------------------------------------------------


def _pad(w, rows, cols, top=0):
    return F.pad(w, (0, cols - w.shape[1], top, rows - top - w.shape[0]))


def pack_film_params(params: dict, use_dir: bool) -> dict:
    """``FilmSirenNeRF`` parameters (``named_parameters()`` names) -> padded
    ``[in, out]`` tensors (``pack_film_params`` of the JAX package): W0 holds
    the position rows 0..2 of an 8-row pad, W8b puts the direction rows at
    input columns 3..5, the heads are padded to 8 lanes."""
    out = {"W0": _pad(params["input.weight"].t(), IN_PAD, HID),
           "b0": params["input.bias"][None]}
    for i in range(7):
        out[f"W{i + 1}"] = params[f"hidden.{i}.weight"].t()
        out[f"b{i + 1}"] = params[f"hidden.{i}.bias"][None]
    w8 = params["rgb_hidden.weight"].t()
    out["W8a"] = w8[:HID]
    out["W8b"] = (_pad(w8[HID:], IN_PAD, HID, top=3) if use_dir
                  else w8.new_zeros(IN_PAD, HID))
    out["b8"] = params["rgb_hidden.bias"][None]
    out["Ws"] = _pad(params["sigma.weight"].t(), HID, OUT_PAD)
    out["bs"] = _pad(params["sigma.bias"][None], 1, OUT_PAD)
    out["Wr"] = _pad(params["rgb.weight"].t(), HID, OUT_PAD)
    out["br"] = _pad(params["rgb.bias"][None], 1, OUT_PAD)
    return {k: out[k] for k in PACK_KEYS}


def unpack_film_grads(grads: list, use_dir: bool) -> dict:
    """Packed gradients (``PACK_KEYS`` order) -> the parameters' gradients,
    by name and in their torch layout (``_unpack_grads`` of the JAX
    package, transposed)."""
    g = dict(zip(PACK_KEYS, grads))
    out = {"input.weight": g["W0"][:3].t(), "input.bias": g["b0"][0],
           "sigma.weight": g["Ws"][:, :1].t(), "sigma.bias": g["bs"][0, :1],
           "rgb.weight": g["Wr"][:, :3].t(), "rgb.bias": g["br"][0, :3],
           "rgb_hidden.bias": g["b8"][0]}
    for i in range(7):
        out[f"hidden.{i}.weight"] = g[f"W{i + 1}"].t()
        out[f"hidden.{i}.bias"] = g[f"b{i + 1}"][0]
    w8 = (torch.cat([g["W8a"], g["W8b"][3:6]], dim=0) if use_dir
          else g["W8a"])
    out["rgb_hidden.weight"] = w8.t()
    return out


def pad_points(x: torch.Tensor, n_img: int):
    """``[B, ..., 6]`` points -> (zero-padded ``[B, P_pad, 8]``, P), P_pad the
    next multiple of ``PT_MULT``."""
    flat = x.reshape(n_img, -1, x.shape[-1]).float()
    p = flat.shape[1]
    return F.pad(flat, (0, IN_PAD - flat.shape[2], 0, (-p) % PT_MULT)), p


def weight_stacks(w) -> tuple:
    """The bf16 per-tile pass's two weight streams, each ``[8 * 256, 256]``
    row-major, in the order its products read them: the forward stack
    ``[W1, ..., W7, W8a]`` and the backward stack ``[W8a^T, W7^T, ...,
    W1^T]``."""
    d = dict(zip(PACK_KEYS, w))
    fwd = [d[f"W{l}"] for l in range(1, 8)] + [d["W8a"]]
    return (torch.cat(fwd).contiguous(),
            torch.cat([t.t() for t in reversed(fwd)]).contiguous())


def tf32_split(a: torch.Tensor) -> tuple:
    """(big, small) of fp32 ``a``: big = a rounded to tf32 (to nearest, ties
    away from zero: the bit arithmetic of ``cvt.rna.tf32.f32``, the low 13
    bits zero), small = a - big (exact), so big + small == a."""
    bits = a.float().contiguous().view(torch.int32)
    big = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return big, a - big


def tf32_stack(w) -> torch.Tensor:
    """The fp32 K8's weight stream, ``[2 * 8 * 256, 256]`` fp32: the forward
    products' weights [W1, ..., W7, W8a] K-major (each ``W^T`` of the packed
    ``[in, out]``: one row of 256 inputs per output column) rounded to tf32,
    then their remainders (``tf32_split``).  Built on the weights' device."""
    d = dict(zip(PACK_KEYS, w))
    fwd = torch.cat([d[f"W{l}"].t() for l in range(1, 8)] + [d["W8a"].t()])
    return torch.cat(tf32_split(fwd.float())).contiguous()


def cta_tiles(n_tiles: int) -> list:
    """The bf16 pass's CTAs, each as its two warpgroups' tiles (None for a
    warpgroup without one: the second of the last CTA when n_tiles is
    odd)."""
    return [(2 * c, 2 * c + 1 if 2 * c + 1 < n_tiles else None)
            for c in range((n_tiles + 1) // 2)]


def tf32_a_offset(p: int, col: int) -> int:
    """Byte offset of (point p, column col) in either half of the fp32 K8's
    activations (``tf_a_offset``): the 32-column block, then the point's
    128-byte row with its 16-byte chunks permuted by the 128-byte swizzle."""
    return ((col // 32) * TF_A_BLOCK + p * 128 + ((((col >> 2) ^ p) & 7) << 4)
            + (col & 3) * 4)


def a_buffer_offset(p: int, col: int) -> int:
    """Byte offset of (point p, column col) in a warpgroup's activation
    buffer (``a_offset``): the 64-column block, then the point's 128-byte
    row with its 16-byte chunks permuted by the 128-byte swizzle."""
    c = col % 64
    return ((col // 64) * TC_A_BLOCK + p * 128 + (((c >> 3) ^ p) & 7) * 16
            + (c & 7) * 2)


def kernel_weights(w, bf16: bool) -> list:
    """The packed weights as the kernels take them: W* in bf16 when
    ``bf16`` (the rounding every matmul applies anyway), biases fp32."""
    return [t.to(torch.bfloat16).contiguous()
            if (bf16 and k in _W_KEYS) else t.float().contiguous()
            for k, t in zip(PACK_KEYS, w)]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _round(a, bf16):
    """Round to bf16 (kept in fp32 for the arithmetic) when bf16."""
    return a.to(torch.bfloat16).float() if bf16 else a


def _mm(a, b, bf16):
    return _round(a, bf16) @ _round(b, bf16)


def _gamma_beta(film, layer):
    """film [B, 9, 512] -> gamma, beta [B, 1, 256] of one FiLM layer."""
    row = film[:, layer:layer + 1]
    return row[..., :HID], row[..., HID:]


def _fast(fast_sin):
    """The sine a call takes: ``fast_sin``, or ``USE_FAST_SIN`` when None."""
    return core_nn.USE_FAST_SIN if fast_sin is None else bool(fast_sin)


def _forward(x, film, w, bf16, store_bf16=False, fast=None):
    """The trunk on x [B, P, 8]: (u_l, h_l for l = 0..8, sigma, rgb), u_l
    and h_l rounded to bf16 when ``store_bf16`` (``_forward_tile``)."""
    st = (lambda a: _round(a, store_bf16))
    us, hs = [], []
    h = x
    for l in range(8):
        u = _mm(h, w[f"W{l}"], bf16) + w[f"b{l}"]
        g, be = _gamma_beta(film, l)
        h = trunk_sin(W0_CONST * (g * u + be), fast)
        us.append(st(u))
        hs.append(st(h))
    sig = torch.relu(_mm(h, w["Ws"], bf16) + w["bs"])
    u8 = _mm(h, w["W8a"], bf16) + _mm(x, w["W8b"], bf16) + w["b8"]
    g, be = _gamma_beta(film, 8)
    h8 = trunk_sin(W0_CONST * (g * u8 + be), fast)
    rgb = torch.sigmoid(_mm(h8, w["Wr"], bf16) + w["br"])
    us.append(st(u8))
    hs.append(st(h8))
    return us, hs, sig, rgb


def film_mlp_fwd_plain(x: torch.Tensor, film: torch.Tensor, w,
                       bf16: bool, fast_sin: bool | None = None
                       ) -> torch.Tensor:
    """Plain version of K8: out ``[B, P, 8]`` = rgb(3), sigma, zeros."""
    w = dict(zip(PACK_KEYS, (t.float() for t in w)))
    _, _, sig, rgb = _forward(x.float(), film.float(), w, bf16,
                              fast=fast_sin)
    return torch.cat([rgb[..., :3], sig[..., :1],
                      rgb.new_zeros(*rgb.shape[:-1], OUT_PAD - 4)], dim=-1)


def film_mlp_bwd_plain(x: torch.Tensor, film: torch.Tensor, dy: torch.Tensor,
                       w, bf16: bool, need_dx: bool = True,
                       fast_sin: bool | None = None):
    """Plain version of K7: (dx ``[B, P, 8]`` or None, dfilm ``[B, 9, 512]``,
    the 23 packed gradients in ``PACK_KEYS`` order), fp32."""
    w = dict(zip(PACK_KEYS, (t.float() for t in w)))
    x, film, dy = x.float(), film.float(), dy.float()
    fast = _fast(fast_sin)  # read once: the forward and the chain agree
    us, hs, sig, rgb = _forward(x, film, w, bf16, store_bf16=bf16, fast=fast)
    g = {}
    dfilm = [None] * N_FILM

    def mmT(act, delta):  # act^T @ delta over every point of every image
        return _mm(act.reshape(-1, act.shape[-1]).t(),
                   delta.reshape(-1, delta.shape[-1]), bf16)

    def mmB(delta, wmat):  # delta @ W^T
        return _mm(delta, wmat.t(), bf16)

    def colsum(d):
        return d.sum(dim=(0, 1))[None]

    def film_layer_bwd(l, dh):
        """dh (the grad w.r.t. h_l) -> du_l; dfilm row l = (sum dv u, sum
        dv) per image, with the stored (rounded) u."""
        u = us[l]
        gm, be = _gamma_beta(film, l)
        dv = dh * W0_CONST * trunk_sin_vjp(W0_CONST * (gm * u + be), fast)
        dfilm[l] = torch.cat([(dv * u).sum(dim=1), dv.sum(dim=1)], dim=-1)
        return dv * gm

    lane = torch.arange(OUT_PAD, device=dy.device)
    drgb = torch.where(lane < 3, dy, 0.0)
    dsig = F.pad(dy[..., 3:4] * (sig[..., :1] > 0).float(), (0, OUT_PAD - 1))
    dr_pre = drgb * rgb * (1.0 - rgb)
    g["Wr"], g["br"] = mmT(hs[8], dr_pre), colsum(dr_pre)
    du8 = film_layer_bwd(8, mmB(dr_pre, w["Wr"]))
    g["W8a"], g["W8b"], g["b8"] = mmT(hs[7], du8), mmT(x, du8), colsum(du8)
    dx = mmB(du8, w["W8b"]) if need_dx else None
    g["Ws"], g["bs"] = mmT(hs[7], dsig), colsum(dsig)
    dh = mmB(du8, w["W8a"]) + mmB(dsig, w["Ws"])
    for l in range(7, 0, -1):
        du = film_layer_bwd(l, dh)
        g[f"W{l}"], g[f"b{l}"] = mmT(hs[l - 1], du), colsum(du)
        dh = mmB(du, w[f"W{l}"])
    du0 = film_layer_bwd(0, dh)
    g["W0"], g["b0"] = mmT(x, du0), colsum(du0)
    if need_dx:
        dx = dx + mmB(du0, w["W0"])
    return dx, torch.stack(dfilm, dim=1), [g[k] for k in PACK_KEYS]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    from .build import load

    lib = load("film_mlp")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.film_mlp_fwd.argtypes = [p, p, ctypes.POINTER(p), p, p, i, i, i,
                                     i, p]
        lib.film_mlp_fwd.restype = i
        lib.film_mlp_bwd.argtypes = [
            p, p, p, ctypes.POINTER(p), p, p, i, i, i, p, p, p, p, p, p, i,
            ctypes.POINTER(ctypes.c_int), i, p, i, p, p, i, i, p]
        lib.film_mlp_bwd.restype = i
        lib.film_sin_eval.argtypes = [p, p, i, i, p]
        lib.film_sin_eval.restype = i
        lib._argtypes_set = True
    return lib


def _check(t, name, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_inputs(x, film, w, bf16):
    """Validates x [B, P, 8], film [B, 9, 512] and the kernel weights;
    returns (B, P, the weights' pointer array)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, P, {IN_PAD}], got {tuple(x.shape)}")
    n_img, n_pts = x.shape[:2]
    if n_pts % PT_MULT:
        raise ValueError(f"points per image {n_pts} is not a multiple of "
                         f"{PT_MULT}")
    dev = x.device
    _check(x, "x", (n_img, n_pts, IN_PAD), torch.float32, dev)
    _check(film, "film", (n_img, N_FILM, 2 * HID), torch.float32, dev)
    if len(w) != len(PACK_KEYS):
        raise ValueError(f"expected {len(PACK_KEYS)} packed weights")
    for k, t in zip(PACK_KEYS, w):
        dt = torch.bfloat16 if (bf16 and k in _W_KEYS) else torch.float32
        _check(t, k, PACK_SHAPES[k], dt, dev)
    return n_img, n_pts, (ctypes.c_void_p * len(w))(*[t.data_ptr() for t in w])


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def film_mlp_fwd(x: torch.Tensor, film: torch.Tensor, w,
                 bf16: bool = True, fast_sin: bool | None = None
                 ) -> torch.Tensor:
    """K8: out ``[B, P, 8]`` fp32.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/film_mlp.cu``: ``film_fwd_tc_kernel`` in bf16,
    ``film_fwd_tf32_kernel`` (3xTF32) in fp32, counted in ``launches`` and,
    in fp32, also in ``launches_f32``; the exact-sine instantiation also in
    ``launches_exact``."""
    fast = _fast(fast_sin)
    if x.device.type == "cpu":
        return film_mlp_fwd_plain(x, film, w, bf16, fast)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n_img, n_pts, wp = _check_inputs(x, film, w, bf16)
    out = torch.empty((n_img, n_pts, OUT_PAD), dtype=torch.float32,
                      device=x.device)
    stack = weight_stacks(w)[0] if bf16 else tf32_stack(w)
    with torch.cuda.device(x.device):
        err = _lib().film_mlp_fwd(x.data_ptr(), film.data_ptr(), wp,
                                  stack.data_ptr(), out.data_ptr(), n_img,
                                  n_pts, int(bf16), int(not fast),
                                  _stream(x.device))
    if err:
        raise RuntimeError(f"film_mlp_fwd launch failed: CUDA error {err}")
    film_mlp_fwd.launches += 1
    film_mlp_fwd.launches_f32 += not bf16
    film_mlp_fwd.launches_exact += not fast
    return out


film_mlp_fwd.launches = film_mlp_fwd.launches_f32 = 0
film_mlp_fwd.launches_exact = 0


def grad_tasks() -> list:
    """K7's dW task table, one row per packed weight: (act column, rows M,
    delta column, cols N, offset in the flat gradient)."""
    rows = []
    for k in GRAD_KEYS:
        if k not in _W_KEYS:
            continue
        act, delta = GRAD_PAIRS[k]
        m, n = PACK_SHAPES[k]
        a0, a1 = ACT_OFFS[act]
        d0, d1 = DELTA_OFFS[delta]
        assert a1 - a0 == m and d1 - d0 == n, k
        rows.append((a0, m, d0, n, GRAD_OFFS[k][0]))
    return rows


_TASKS = [v for row in grad_tasks() for v in row]


def bwd_splits(n: int) -> int:
    """Point ranges K7's dW pass splits a chunk's points into."""
    return max(1, min(16, n // 4096))


def chunk_images(n_img: int, n_pts: int, bf16: bool) -> int:
    """Images per pass of K7, so that its scratch stays within
    ``SCRATCH_BYTES``."""
    tm = 64 if bf16 else 32
    per_pt = (ACT_W + U_W + DELTA_W) * (2 if bf16 else 4) + SUM_W * 4 / tm
    return max(1, min(n_img, int(SCRATCH_BYTES // (n_pts * per_pt))))


def film_mlp_bwd(x: torch.Tensor, film: torch.Tensor, dy: torch.Tensor, w,
                 bf16: bool = True, need_dx: bool = True,
                 fast_sin: bool | None = None):
    """K7: (dx ``[B, P, 8]`` or None, dfilm ``[B, 9, 512]``, the 23 packed
    gradients in ``PACK_KEYS`` order), fp32.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/film_mlp.cu`` (bitwise
    reproducible), counted in ``launches`` and, with the exact sine, in
    ``launches_exact``."""
    fast = _fast(fast_sin)
    if x.device.type == "cpu":
        return film_mlp_bwd_plain(x, film, dy, w, bf16, need_dx, fast)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n_img, n_pts, wp = _check_inputs(x, film, w, bf16)
    dev = x.device
    _check(dy, "dy", (n_img, n_pts, OUT_PAD), torch.float32, dev)
    cb = chunk_images(n_img, n_pts, bf16)
    rows = cb * n_pts
    dt = torch.bfloat16 if bf16 else torch.float32
    splits = bwd_splits(rows)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    acts, us, deltas = (empty(rows, ACT_W, dtype=dt), empty(rows, U_W, dtype=dt),
                        empty(rows, DELTA_W, dtype=dt))
    tile_sums = empty(rows // (TC_TILE if bf16 else 32), SUM_W)
    img_sums = empty(n_img, SUM_W)
    partials = empty(splits, BIAS_OFF)
    grads = empty(GRAD_TOTAL)
    dfilm = empty(n_img, N_FILM, 2 * HID)
    dx = empty(n_img, n_pts, IN_PAD) if need_dx else None
    tasks = (ctypes.c_int * len(_TASKS))(*_TASKS)
    stacks = weight_stacks(w) if bf16 else (None, None)
    with torch.cuda.device(dev):
        err = _lib().film_mlp_bwd(
            x.data_ptr(), film.data_ptr(), dy.data_ptr(), wp,
            *(t.data_ptr() if bf16 else None for t in stacks), n_img, n_pts,
            cb, acts.data_ptr(), us.data_ptr(), deltas.data_ptr(),
            tile_sums.data_ptr(), img_sums.data_ptr(), partials.data_ptr(),
            splits, tasks, len(_TASKS) // 5, grads.data_ptr(), BIAS_OFF,
            dfilm.data_ptr(), dx.data_ptr() if need_dx else None, int(bf16),
            int(not fast), _stream(dev))
    if err:
        raise RuntimeError(f"film_mlp_bwd launch failed: CUDA error {err}")
    film_mlp_bwd.launches += 1
    film_mlp_bwd.launches_exact += not fast
    DW.dw_splitk.launches += -(-n_img // cb) if bf16 else 0  # one per chunk
    return dx, dfilm, [grads[GRAD_OFFS[k][0]:GRAD_OFFS[k][1]].view(
        PACK_SHAPES[k]) for k in PACK_KEYS]


film_mlp_bwd.launches = film_mlp_bwd.launches_exact = 0


def sin_eval(v: torch.Tensor, fast_sin: bool, vjp: bool = False
             ) -> torch.Tensor:
    """The kernels' trunk sine (``vjp``: its derivative) on fp32 ``v``, for
    measuring its accuracy: on a CUDA tensor the device functions of
    ``csrc/film_mlp.cu`` (``film_sin_eval``), on a CPU tensor
    ``trunk_sin``/``trunk_sin_vjp``."""
    if v.device.type == "cpu":
        return (trunk_sin_vjp if vjp else trunk_sin)(v.float(), fast_sin)
    _check(v, "v", (v.numel(),), torch.float32, v.device)
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        err = _lib().film_sin_eval(v.data_ptr(), out.data_ptr(), v.numel(),
                                   1 + int(vjp) + 2 * int(not fast_sin),
                                   _stream(v.device))
    if err:
        raise RuntimeError(f"film_sin_eval launch failed: CUDA error {err}")
    sin_eval.launches += 1
    return out


sin_eval.launches = 0

KERNELS = (film_mlp_fwd, film_mlp_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = k.launches_exact = 0
    film_mlp_fwd.launches_f32 = 0


# ---------------------------------------------------------------------------
# Autograd: the custom VJP of fused_film_apply
# ---------------------------------------------------------------------------


class FilmTrunkFunction(torch.autograd.Function):
    """The FiLM trunk with K7 as its backward.  ``primal(x, film,
    fast_sin)`` computes the forward through K8 (``k8_primal``): in
    ``fused_film_apply``'s precision, or in fp32 for the hybrid mode of
    models/pigan.py; no graph is recorded, and the residuals are only the
    parameters, x and film.  The trunk sine is read once, here, and the
    backward takes the same one."""

    @staticmethod
    def forward(ctx, x, film, primal, names, use_dir, bf16, need_dx,
                *params):
        ctx.names, ctx.use_dir, ctx.bf16, ctx.need_dx = (names, use_dir,
                                                         bf16, need_dx)
        ctx.fast_sin = core_nn.USE_FAST_SIN
        ctx.save_for_backward(x, film, *params)
        return primal(x, film, ctx.fast_sin)

    @staticmethod
    def backward(ctx, dy):
        x, film, *params = ctx.saved_tensors
        packed = pack_film_params(dict(zip(ctx.names, params)), ctx.use_dir)
        w = kernel_weights([packed[k] for k in PACK_KEYS], ctx.bf16)
        n_img = film.shape[0]
        x_pad, p = pad_points(x, n_img)
        dy_pad = F.pad(dy.reshape(n_img, p, 4).float(),
                       (0, OUT_PAD - 4, 0, x_pad.shape[1] - p))
        dx_pad, dfilm, grads = film_mlp_bwd(x_pad, film.contiguous().float(),
                                            dy_pad, w, ctx.bf16, ctx.need_dx,
                                            ctx.fast_sin)
        if ctx.need_dx:
            dx = dx_pad[:, :p, :6].reshape(x.shape)
        else:
            dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        g = unpack_film_grads(grads, ctx.use_dir)
        return (dx, dfilm, None, None, None, None, None,
                *(g[n] for n in ctx.names))


def fused_film_apply(params: dict, x: torch.Tensor, film: torch.Tensor,
                     use_dir: bool = True, bf16: bool = True,
                     need_dx: bool = True) -> torch.Tensor:
    """The trunk through K8 (forward) and K7 (backward): ``params`` the
    trunk's ``named_parameters()``, x ``[B, ..., 6]``, film ``[B, 9, 512]``
    -> ``[B, ..., 4]``, differentiable in the parameters, x and film.
    ``need_dx=False`` skips the input gradient (zeros are returned for it):
    only for callers whose x carries no gradient."""
    names = tuple(params)
    return FilmTrunkFunction.apply(x, film, k8_primal(params, use_dir, bf16),
                                   names, use_dir, bf16, need_dx,
                                   *(params[n] for n in names))


def k8_primal(params: dict, use_dir: bool, bf16: bool):
    """``primal(x, film, fast_sin)``: the trunk through K8 (``film_mlp_fwd``
    in bf16 or fp32), x ``[B, ..., 6]``, film ``[B, 9, 512]`` -> ``[B, ...,
    4]``."""

    def primal(x, film, fast_sin):
        n_img = film.shape[0]
        packed = pack_film_params(params, use_dir)
        w = kernel_weights([packed[k] for k in PACK_KEYS], bf16)
        x_pad, p = pad_points(x, n_img)
        out = film_mlp_fwd(x_pad, film.contiguous().float(), w, bf16,
                           fast_sin)
        return out[:, :p, :4].reshape(*x.shape[:-1], 4)

    return primal
