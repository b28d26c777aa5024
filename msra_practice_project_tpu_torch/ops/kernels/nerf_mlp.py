"""Fused NeRF MLP: the port of ``fused_nerf_apply`` and its six kernels.

Port of ``msra_practice_project_tpu/ops/pallas/nerf_mlp.py``:
  K1 ``nerf_mlp_fwd_save``   <- ``_fwd_save_kernel`` (``_fused_forward_save``)
  K2 ``nerf_mlp_bwd_saved``  <- ``_bwd_saved_kernel`` + ``_grad_body``
     (its delta chain alone: ``nerf_mlp_deltas``)
  K3 ``nerf_mlp_fwd``        <- ``_fwd_kernel`` (``_fused_forward``)
  K6 ``nerf_mlp_fwd_pipelined`` <- ``_fwd_kernel_pipelined`` (``pipe=True``)
  K5 ``nerf_mlp_bwd``        <- ``_bwd_kernel`` + ``_grad_body`` (recompute)
  K4 ``nerf_mlp_dx``         <- ``_grad_body``'s ``need_dx`` block
and ``nerf_mlp_fwd_tf32``, K3's function within the fp32 gate (1e-4 of
max|ref|) as 3xTF32 products on wgmma (``nerf_fwd_tf32_kernel``): about
21-bit products, not exact fp32 ones.  It replaces no TPU kernel:
it is the port's route for the forwards that autograd does not record
(``nerf_forward_tf32``, which ``NeRFModel.forward`` takes for the view
renders).
The CUDA kernels are ``csrc/nerf_mlp.cu``; the source notes there give the
bound on an H100 and the design.  In bf16, K1, K3 and K6 are one kernel on
wgmma (``nerf_fwd_tc_kernel``) and K2's delta chain another
(``nerf_bwd_delta_tc_kernel``), K5 runs both per chunk; each streams one
weight stack (``weight_stacks``, in the order of ``FWD_SCHEDULE`` and
``BWD_SCHEDULE``, 32 rows per stage) and moves activations and deltas by
TMA in boxes of 64 columns.  K4 in bf16 (``dx_tc_kernel``) keeps W5a, W0
and W9b in shared memory and streams the deltas it reads by TMA, from K2's
workspace or K5's copy alike, into wgmma products.

Each kernel has a plain PyTorch version here with the same ``bf16`` switch:
with ``bf16=True`` it rounds matmul operands and stored activations to bf16
exactly where the JAX kernel's ``_mm``/``store_bf16``/``mmT_acc``/``mmB`` do
and accumulates in fp32; with ``bf16=False`` everything is fp32.  A wrapper
takes the plain version only for tensors on the CPU; a CUDA tensor launches
the kernel or raises.

Shapes (points padded to a multiple of ``ROW_MULT``, zero rows):
  x ``[N, 8]`` = pos(3), dir(3), pad(2);  out ``[N, 8]`` = rgb(3), sigma(1),
  zeros;  acts ``[N, 2560]`` in ``ACT_SLOTS`` order;  weights in
  ``PACK_KEYS`` order with the padded ``[in, out]`` shapes of
  ``pack_nerf_params``;  the deltas K4 reads are ``(dh9, dh5, dh0)``,
  ``[N, 128]``, ``[N, 256]``, ``[N, 256]``, stored as the delta chain stores
  them (bf16 when ``bf16``).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ...core.diagnostics import span
from ...core.nn import positional_encoding
from . import dw_splitk as DW
from .film_mlp import tf32_split

IN_PAD = 8       # [pos(3), dir(3), pad(2)]
PE_POS = 64      # 60 used
PE_DIR = 32      # 24 used
HID = 256
RGB_HID = 128
OUT_PAD = 8      # [rgb(3), sigma(1), pad(4)]
ROW_MULT = 128   # point padding: a multiple of every kernel's row tile

PACK_KEYS = ["W0", "b0", "W1", "b1", "W2", "b2", "W3", "b3", "W4", "b4",
             "W5a", "W5b", "b5", "W6", "b6", "W7", "b7", "W8", "b8",
             "W9a", "W9b", "b9", "Ws", "bs", "Wr", "br"]
_W_KEYS = frozenset(k for k in PACK_KEYS if k.startswith("W"))

ACT_SLOTS = ([("pe_p", PE_POS), ("pe_d", PE_DIR)]
             + [(f"h{i}", HID) for i in range(8)]
             + [("hd", HID), ("h9", RGB_HID)])
ACT_W = sum(w for _, w in ACT_SLOTS)          # 2528
ACT_PAD = -(-ACT_W // 128) * 128              # 2560


def _offsets(slots):
    offs, o = {}, 0
    for name, w in slots:
        offs[name] = (o, o + w)
        o += w
    return offs, o


ACT_OFFS, _ = _offsets(ACT_SLOTS)

# K2's per-point deltas (the gradients w.r.t. each layer's pre-activation):
# rgb head, sigma head, then the chain from h9 down to h0.
DELTA_SLOTS = ([("dr", OUT_PAD), ("dsig", OUT_PAD), ("dh9", RGB_HID),
                ("dhd", HID)] + [(f"dh{i}", HID) for i in range(7, -1, -1)])
DELTA_OFFS, DELTA_W = _offsets(DELTA_SLOTS)   # DELTA_W = 2448

# dW = act^T . delta and db = 1^T . delta, per packed parameter.
GRAD_PAIRS = {
    "W0": ("pe_p", "dh0"), "W1": ("h0", "dh1"), "W2": ("h1", "dh2"),
    "W3": ("h2", "dh3"), "W4": ("h3", "dh4"), "W5a": ("pe_p", "dh5"),
    "W5b": ("h4", "dh5"), "W6": ("h5", "dh6"), "W7": ("h6", "dh7"),
    "W8": ("h7", "dhd"), "W9a": ("hd", "dh9"), "W9b": ("pe_d", "dh9"),
    "Ws": ("h7", "dsig"), "Wr": ("h9", "dr"),
    "b0": (None, "dh0"), "b1": (None, "dh1"), "b2": (None, "dh2"),
    "b3": (None, "dh3"), "b4": (None, "dh4"), "b5": (None, "dh5"),
    "b6": (None, "dh6"), "b7": (None, "dh7"), "b8": (None, "dhd"),
    "b9": (None, "dh9"), "bs": (None, "dsig"), "br": (None, "dr"),
}

PACK_SHAPES = {
    "W0": (PE_POS, HID), "W5a": (PE_POS, HID), "W5b": (HID, HID),
    "W9a": (HID, RGB_HID), "W9b": (PE_DIR, RGB_HID),
    "Ws": (HID, OUT_PAD), "Wr": (RGB_HID, OUT_PAD),
    "bs": (1, OUT_PAD), "br": (1, OUT_PAD), "b9": (1, RGB_HID),
    **{f"W{i}": (HID, HID) for i in (1, 2, 3, 4, 6, 7, 8)},
    **{f"b{i}": (1, HID) for i in range(9)},
}
GRAD_OFFS, GRAD_TOTAL = _offsets(
    [(k, PACK_SHAPES[k][0] * PACK_SHAPES[k][1]) for k in PACK_KEYS])

# K5's copy of the deltas K4 reads (the layers whose input is a PE)
PE_DELTA_SLOTS = [("dh9", RGB_HID), ("dh5", HID), ("dh0", HID)]
PE_DELTA_OFFS, PE_DELTA_W = _offsets(PE_DELTA_SLOTS)    # PE_DELTA_W = 640


# The bf16 kernels' products in the order they stream their weight stack,
# each K / 32 ring stages of 32 rows (csrc/nerf_mlp.cu, "bf16: the forward
# and the delta chain on wgmma"; tests/test_torch_nerf_tc.py emulates
# them).  Forward: (weight, A operand, the activation written after it, or
# None when the next product accumulates onto it).
FWD_SCHEDULE = (
    [("W0", "pe_p", "h0")] + [(f"W{i}", "act", f"h{i}") for i in range(1, 5)]
    + [("W5a", "pe_p", None), ("W5b", "act", "h5"), ("W6", "act", "h6"),
       ("W7", "act", "h7"), ("W8", "act", "hd"), ("W9a", "act", None),
       ("W9b", "pe_d", "h9")])
# Backward: (weight, used transposed; the delta written after it; the
# activation whose relu mask it takes, or None); dh9 comes before, from
# the heads.
BWD_SCHEDULE = (
    [("W9a", "dhd", None), ("W8", "dh7", "h7"), ("W7", "dh6", "h6"),
     ("W6", "dh5", "h5"), ("W5b", "dh4", "h4")]
    + [(f"W{i}", f"dh{i - 1}", f"h{i - 1}") for i in (4, 3, 2, 1)])


# ---------------------------------------------------------------------------
# Packing (differentiable, so autograd unpacks the packed gradients)
# ---------------------------------------------------------------------------


def _pad(w, rows, cols):
    return F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0]))


def pack_nerf_params(model) -> dict:
    """``NeRFModel`` -> padded ``[in, out]`` tensors (``pack_nerf_params`` of
    the JAX package).  Pads, slices and concats only, so gradients w.r.t.
    the packed tensors flow back to the model's parameters."""
    lp, ld = model.layers_pos, model.layers_dir
    w5 = lp[5].weight.t()  # [316, 256] = [60 pe | 256 h]
    w9 = ld[1].weight.t()  # [280, 128] = [256 h | 24 pe_dir]
    out = {"W0": _pad(lp[0].weight.t(), PE_POS, HID), "b0": lp[0].bias[None]}
    for i in (1, 2, 3, 4, 6, 7):
        out[f"W{i}"] = lp[i].weight.t()
        out[f"b{i}"] = lp[i].bias[None]
    out.update(
        W5a=_pad(w5[:60], PE_POS, HID), W5b=w5[60:], b5=lp[5].bias[None],
        W8=ld[0].weight.t(), b8=ld[0].bias[None],
        W9a=w9[:HID], W9b=_pad(w9[HID:], PE_DIR, RGB_HID),
        b9=ld[1].bias[None],
        Ws=_pad(model.sigma.weight.t(), HID, OUT_PAD),
        bs=_pad(model.sigma.bias[None], 1, OUT_PAD),
        Wr=_pad(model.rgb.weight.t(), RGB_HID, OUT_PAD),
        br=_pad(model.rgb.bias[None], 1, OUT_PAD))
    return {k: out[k] for k in PACK_KEYS}


def weight_stacks(w: list) -> tuple:
    """The bf16 kernels' two weight streams, ``[rows, 256]`` row-major in
    the weights' dtype (bf16 for the kernels), each product's rows in the
    order it reads them: the forward stack ``[W0 | W1..W4 | W5a | W5b | W6 |
    W7 | W8 | W9a | W9b]`` (2,464 rows; W9a and W9b zero-padded to 256
    columns) and the backward stack ``[W9a^T, W8^T, W7^T, W6^T, W5b^T,
    W4^T, ..., W1^T]`` (2,176 rows)."""
    return _fwd_stack(w), _bwd_stack(w)


def _fwd_stack(w):
    d = dict(zip(PACK_KEYS, w))  # few ops: a launch builds it on the host
    return torch.cat([d[k] if d[k].shape[1] == HID
                      else F.pad(d[k], (0, HID - d[k].shape[1]))
                      for k, _, _ in FWD_SCHEDULE])


def _bwd_stack(w):
    d = dict(zip(PACK_KEYS, w))
    return torch.cat([d[k].t() for k, _, _ in BWD_SCHEDULE])


# The fp32 kernel's products in the order it streams their weights
# (csrc/nerf_mlp.cu's nt_slices and nt_cols): h5 takes h4 W5b before e_pos
# W5a, so that A holds e_pos again only once h4 is read.
TF32_SCHEDULE = ("W0", "W1", "W2", "W3", "W4", "W5b", "W5a", "W6", "W7", "W8",
                 "W9a", "W9b")
TF32_KS = 32  # K per ring stage: one 128-byte row of fp32


def _tf32_blocks(wt: torch.Tensor) -> torch.Tensor:
    """``[N, K]`` fp32 (a product's W^T) -> its stream rows ``[2 K, N]`` as
    ``[K / 32 * 2 * N, 32]``: per K-slice of 32, the slice rounded to tf32
    (N rows), then its remainder (N rows)."""
    n, k = wt.shape
    halves = torch.stack(tf32_split(wt))           # [2, N, K]
    return (halves.view(2, n, k // TF32_KS, TF32_KS).permute(2, 0, 1, 3)
            .reshape(-1, TF32_KS))


def tf32_stack(w: list) -> torch.Tensor:
    """The fp32 kernel's weight stream, ``[37120, 32]`` fp32: for each product
    in ``TF32_SCHEDULE`` order and each of its K-slices of 32, the slice of
    W^T (one row of inputs per output column, K-major) rounded to tf32, then
    its remainder (``film_mlp.tf32_split``).  W9a and W9b have 128 rows per
    block, the others 256.  Built on the weights' device."""
    d = dict(zip(PACK_KEYS, w))
    return torch.cat([_tf32_blocks(d[k].float().t()) for k in TF32_SCHEDULE])


def pad_points(x: torch.Tensor) -> torch.Tensor:
    """``[..., 6]`` points -> zero-padded ``[N_pad, 8]``, N_pad a multiple of
    ``ROW_MULT``."""
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    return F.pad(flat, (0, IN_PAD - flat.shape[1], 0, (-n) % ROW_MULT))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _round(a, bf16):
    """Round to bf16 (kept in fp32 for the arithmetic) when bf16."""
    return a.to(torch.bfloat16).float() if bf16 else a


def _mm(a, b, bf16):
    return _round(a, bf16) @ _round(b, bf16)


def _pe(x):
    """Both positional encodings, zero-padded to 64 and 32 columns."""
    pe_p = positional_encoding(x[:, 0:3], 10)
    pe_d = positional_encoding(x[:, 3:6], 4)
    return (F.pad(pe_p, (0, PE_POS - pe_p.shape[1])),
            F.pad(pe_d, (0, PE_DIR - pe_d.shape[1])))


def tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """fp32 ``a`` as the tensor cores read a tf32 operand: its low 13 bits
    dropped."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the fp32 kernel computes a product: big(a) big(b) +
    small(a) big(b) + big(a) small(b) (``film_mlp.tf32_split``), each small
    truncated as the tensor cores read it."""
    (ab, as_), (bb, bs) = tf32_split(a), tf32_split(b)
    return tf32_trunc(as_) @ bb + ab @ bb + ab @ tf32_trunc(bs)


def _forward_plain(x: torch.Tensor, w: list, bf16: bool, mm=None):
    """The forward of K1/K3/K5: (out ``[N, 8]`` fp32, the activations by
    ``ACT_SLOTS`` name, fp32 tensors rounded to bf16 when ``bf16``).  ``mm``
    (fp32 only) computes the trunk's and the view branch's products, the
    heads staying plain fp32 products."""
    w = dict(zip(PACK_KEYS, (t.float() for t in w)))
    st = (lambda a: _round(a, bf16))
    mm = mm or (lambda a, b: _mm(a, b, bf16))
    relu = torch.relu
    a = {}
    pe_p, pe_d = _pe(x.float())
    a["pe_p"], a["pe_d"] = st(pe_p), st(pe_d)
    h = a["pe_p"]
    for i in range(5):
        h = a[f"h{i}"] = st(relu(mm(h, w[f"W{i}"]) + w[f"b{i}"]))
    h = a["h5"] = st(relu(mm(a["pe_p"], w["W5a"]) + mm(h, w["W5b"])
                          + w["b5"]))
    for i in (6, 7):
        h = a[f"h{i}"] = st(relu(mm(h, w[f"W{i}"]) + w[f"b{i}"]))
    sig = relu(_mm(h, w["Ws"], bf16) + w["bs"])
    a["hd"] = st(mm(h, w["W8"]) + w["b8"])
    a["h9"] = st(relu(mm(a["hd"], w["W9a"]) + mm(a["pe_d"], w["W9b"])
                      + w["b9"]))
    rgb = torch.sigmoid(_mm(a["h9"], w["Wr"], bf16) + w["br"])
    out = torch.cat([rgb[:, :3], sig[:, :1],
                     rgb.new_zeros(rgb.shape[0], OUT_PAD - 4)], dim=1)
    return out, a


def nerf_mlp_fwd_plain(x: torch.Tensor, w: list, bf16: bool) -> torch.Tensor:
    """Plain version of K3 and of K6 (bitwise equal to K3 by contract): out
    ``[N, 8]`` fp32."""
    return _forward_plain(x, w, bf16)[0]


def nerf_mlp_fwd_tf32_plain(x: torch.Tensor, w: list) -> torch.Tensor:
    """Plain version of the fp32 kernel: K3's fp32 forward with every
    product of the trunk and the view branch as 3xTF32 (``mm_3xtf32``), the
    heads in fp32: out ``[N, 8]``."""
    return _forward_plain(x, w, False, mm_3xtf32)[0]


def nerf_mlp_fwd_save_plain(x: torch.Tensor, w: list, bf16: bool):
    """Plain version of K1: (out ``[N, 8]`` fp32, acts ``[N, 2560]``, bf16
    when ``bf16`` else fp32)."""
    out, a = _forward_plain(x, w, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    acts = torch.cat([a[name] for name, _ in ACT_SLOTS], dim=1)
    acts = F.pad(acts, (0, ACT_PAD - ACT_W)).to(dt)
    return out, acts


def _delta_chain_plain(w: list, dy: torch.Tensor, a: dict, bf16: bool,
                       deltas: dict | None = None):
    """``_grad_body`` with ``need_dx=False`` from the activations ``a``: (the
    26 parameter gradients, fp32, in ``PACK_KEYS`` order and packed shapes;
    the deltas ``(dh9, dh5, dh0)`` as the kernels store them).  Every delta
    goes into ``deltas`` by ``DELTA_SLOTS`` name, fp32, when it is given."""
    w = dict(zip(PACK_KEYS, (t.float() for t in w)))
    g = {}
    dl = {} if deltas is None else deltas

    def mmT(act, delta):  # act^T @ delta
        return _mm(act.t(), delta, bf16)

    def mmB(delta, wmat):  # delta @ W^T
        return _mm(delta, wmat.t(), bf16)

    def acc(wk, bk, act, delta):
        g[wk] = mmT(act, delta)
        if bk is not None:
            g[bk] = delta.sum(dim=0, keepdim=True)

    def mask(act):
        return (act > 0).float()

    sig = torch.relu(_mm(a["h7"], w["Ws"], bf16) + w["bs"])
    rgb = torch.sigmoid(_mm(a["h9"], w["Wr"], bf16) + w["br"])
    lane = torch.arange(OUT_PAD, device=dy.device)
    drgb = torch.where(lane < 3, dy, 0.0)
    dsig = dy[:, 3:4] * mask(sig[:, :1])
    dsig = F.pad(dsig, (0, OUT_PAD - 1))

    dr_pre = dl["dr"] = drgb * rgb * (1.0 - rgb)
    dl["dsig"] = dsig
    acc("Wr", "br", a["h9"], dr_pre)
    dh9 = dl["dh9"] = mmB(dr_pre, w["Wr"]) * mask(a["h9"])
    acc("W9a", "b9", a["hd"], dh9)
    acc("W9b", None, a["pe_d"], dh9)
    dhd = dl["dhd"] = mmB(dh9, w["W9a"])
    acc("Ws", "bs", a["h7"], dsig)
    acc("W8", "b8", a["h7"], dhd)
    dh = dl["dh7"] = (mmB(dsig, w["Ws"]) + mmB(dhd, w["W8"])) * mask(a["h7"])
    acc("W7", "b7", a["h6"], dh)
    dh = dl["dh6"] = mmB(dh, w["W7"]) * mask(a["h6"])
    acc("W6", "b6", a["h5"], dh)
    dh5 = dl["dh5"] = mmB(dh, w["W6"]) * mask(a["h5"])
    acc("W5a", None, a["pe_p"], dh5)
    acc("W5b", "b5", a["h4"], dh5)
    dh = dl["dh4"] = mmB(dh5, w["W5b"]) * mask(a["h4"])
    for i in (4, 3, 2, 1):
        acc(f"W{i}", f"b{i}", a[f"h{i - 1}"], dh)
        dh = dl[f"dh{i - 1}"] = mmB(dh, w[f"W{i}"]) * mask(a[f"h{i - 1}"])
    acc("W0", "b0", a["pe_p"], dh)
    dt = torch.bfloat16 if bf16 else torch.float32
    return [g[k] for k in PACK_KEYS], tuple(t.to(dt) for t in (dh9, dh5, dh))


def nerf_mlp_bwd_saved_plain(w: list, dy: torch.Tensor, acts: torch.Tensor,
                             bf16: bool):
    """Plain version of K2: (the 26 parameter gradients, the deltas
    ``(dh9, dh5, dh0)``) from the saved activations."""
    acts = acts.float()
    a = {name: acts[:, o0:o1] for name, (o0, o1) in ACT_OFFS.items()}
    return _delta_chain_plain(w, dy, a, bf16)


def nerf_mlp_deltas_plain(w: list, dy: torch.Tensor, acts: torch.Tensor,
                          bf16: bool) -> torch.Tensor:
    """K2's delta workspace ``[N, DELTA_W]`` in ``DELTA_SLOTS`` order, as its
    delta chain stores it (bf16 when ``bf16``): the deltas its split-K pass
    reads."""
    acts = acts.float()
    a = {name: acts[:, o0:o1] for name, (o0, o1) in ACT_OFFS.items()}
    dl = {}
    _delta_chain_plain(w, dy, a, bf16, dl)
    dt = torch.bfloat16 if bf16 else torch.float32
    return torch.cat([dl[name] for name, _ in DELTA_SLOTS], dim=1).to(dt)


def nerf_mlp_bwd_plain(x: torch.Tensor, w: list, dy: torch.Tensor,
                       bf16: bool, need_dx: bool = True):
    """Plain version of K5: K1's forward recomputed, then K2's delta chain:
    (the 26 parameter gradients, the deltas ``(dh9, dh5, dh0)`` when
    ``need_dx`` else None)."""
    grads, dh = _delta_chain_plain(w, dy, _forward_plain(x, w, bf16)[1],
                                   bf16)
    return grads, (dh if need_dx else None)


def nerf_mlp_dx_plain(x: torch.Tensor, w: list, dh, bf16: bool):
    """Plain version of K4: dx ``[N, 8]`` fp32 from x and the deltas
    ``(dh9, dh5, dh0)``: ``dpe_p = dh5 W5a^T + dh0 W0^T``, ``dpe_d = dh9
    W9b^T``, then the chain rule through the PE in fp32."""
    w = dict(zip(PACK_KEYS, (t.float() for t in w)))
    dh9, dh5, dh0 = (t.float() for t in dh)
    dpe_p = _mm(dh5, w["W5a"].t(), bf16) + _mm(dh0, w["W0"].t(), bf16)
    dpe_d = _mm(dh9, w["W9b"].t(), bf16)
    x = x.float()
    dx = torch.zeros_like(x)
    for dpe, lo, n_freq in ((dpe_p, 0, 10), (dpe_d, 3, 4)):
        d = dpe[:, :6 * n_freq].reshape(-1, n_freq, 2, 3)  # [sin_f | cos_f]
        scale = 2.0 ** torch.arange(n_freq, dtype=x.dtype, device=x.device)
        arg = x[:, None, lo:lo + 3] * scale[:, None]
        d_arg = d[:, :, 0] * torch.cos(arg) - d[:, :, 1] * torch.sin(arg)
        dx[:, lo:lo + 3] = (d_arg * scale[:, None]).sum(dim=1)
    return dx


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    from .build import load

    lib = load("nerf_mlp")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        pp, ip = ctypes.POINTER(p), ctypes.POINTER(ctypes.c_int)
        lib.nerf_mlp_fwd_save.argtypes = [p, pp, p, p, p, i, i, p]
        lib.nerf_mlp_fwd.argtypes = [p, pp, p, p, i, i, i, p]
        lib.nerf_mlp_deltas.argtypes = [pp, p, p, p, p, i, i, p]
        lib.nerf_mlp_bwd_saved.argtypes = [pp, p, p, p, p, p, p, i, i, ip, i,
                                           i, p]
        lib.nerf_mlp_bwd.argtypes = [p, pp, p, p, p, p, p, i, p, p, p, i, i,
                                     ip, i, i, p]
        lib.nerf_mlp_dx.argtypes = [p, pp, p, p, p, i, p, i, i, p]
        lib.nerf_mlp_fwd_tf32.argtypes = [p, pp, p, p, i, p]
        for fn in (lib.nerf_mlp_fwd_save, lib.nerf_mlp_fwd,
                   lib.nerf_mlp_deltas, lib.nerf_mlp_bwd_saved,
                   lib.nerf_mlp_bwd, lib.nerf_mlp_dx, lib.nerf_mlp_fwd_tf32):
            fn.restype = i
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


def _check_rows(t, name, width) -> int:
    """Validates a CUDA fp32 ``[N, width]`` tensor of points; returns N."""
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    n = t.shape[0]
    if n % ROW_MULT:
        raise ValueError(f"point count {n} is not a multiple of {ROW_MULT}")
    _check(t, name, (n, width), torch.float32, t.device)
    return n


def _check_weights(w, bf16, device):
    if len(w) != len(PACK_KEYS):
        raise ValueError(f"expected {len(PACK_KEYS)} packed weights")
    for k, t in zip(PACK_KEYS, w):
        dt = torch.bfloat16 if (bf16 and k in _W_KEYS) else torch.float32
        _check(t, k, PACK_SHAPES[k], dt, device)
    return (ctypes.c_void_p * len(w))(*[t.data_ptr() for t in w])


def kernel_weights(w: list, bf16: bool) -> list:
    """The packed weights as the kernels take them: W* in bf16 when
    ``bf16`` (the rounding every matmul applies anyway), biases fp32."""
    return [t.to(torch.bfloat16).contiguous()
            if (bf16 and k in _W_KEYS) else t.float().contiguous()
            for k, t in zip(PACK_KEYS, w)]


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def nerf_mlp_fwd_save(x: torch.Tensor, w: list, bf16: bool = True):
    """K1: (out ``[N, 8]`` fp32, acts ``[N, 2560]``).  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/nerf_mlp.cu``."""
    if x.device.type == "cpu":
        return nerf_mlp_fwd_save_plain(x, w, bf16)
    n = _check_rows(x, "x", IN_PAD)
    wp = _check_weights(w, bf16, x.device)
    out = torch.empty((n, OUT_PAD), dtype=torch.float32, device=x.device)
    acts = torch.empty((n, ACT_PAD), device=x.device,
                       dtype=torch.bfloat16 if bf16 else torch.float32)
    with torch.cuda.device(x.device):
        stack = _fwd_stack(w) if bf16 else None
        _raise_on(_lib().nerf_mlp_fwd_save(
            x.data_ptr(), wp, _ptr(stack), out.data_ptr(), acts.data_ptr(), n,
            int(bf16), _stream(x.device)), "nerf_mlp_fwd_save")
    nerf_mlp_fwd_save.launches += 1
    return out, acts


nerf_mlp_fwd_save.launches = 0


def _launch_fwd(x: torch.Tensor, w: list, bf16: bool, pipe: bool,
                name: str) -> torch.Tensor:
    """Launches K3, or K6 with ``pipe``, on CUDA tensors: out ``[N, 8]``."""
    n = _check_rows(x, "x", IN_PAD)
    wp = _check_weights(w, bf16, x.device)
    out = torch.empty((n, OUT_PAD), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stack = _fwd_stack(w) if bf16 else None
        _raise_on(_lib().nerf_mlp_fwd(
            x.data_ptr(), wp, _ptr(stack), out.data_ptr(), n, int(pipe),
            int(bf16), _stream(x.device)), name)
    return out


def nerf_mlp_fwd(x: torch.Tensor, w: list, bf16: bool = True) -> torch.Tensor:
    """K3: out ``[N, 8]`` fp32, no activations kept.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/nerf_mlp.cu``."""
    if x.device.type == "cpu":
        return nerf_mlp_fwd_plain(x, w, bf16)
    out = _launch_fwd(x, w, bf16, False, "nerf_mlp_fwd")
    nerf_mlp_fwd.launches += 1
    return out


nerf_mlp_fwd.launches = 0


def nerf_mlp_fwd_pipelined(x: torch.Tensor, w: list,
                           bf16: bool = True) -> torch.Tensor:
    """K6 (``_fused_forward``'s ``pipe=True``): K3's forward as two chains,
    bitwise equal to K3 (in bf16 it is K3's kernel, whose two warpgroups,
    one tile each on one weight stream, are the two chains).  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/nerf_mlp.cu``."""
    if x.device.type == "cpu":
        return nerf_mlp_fwd_plain(x, w, bf16)
    out = _launch_fwd(x, w, bf16, True, "nerf_mlp_fwd_pipelined")
    nerf_mlp_fwd_pipelined.launches += 1
    return out


nerf_mlp_fwd_pipelined.launches = 0


def nerf_mlp_fwd_tf32(x: torch.Tensor, w: list) -> torch.Tensor:
    """K3's function within the fp32 gate: out ``[N, 8]`` fp32 from fp32
    weights, every product of the trunk and the view branch as three tf32
    products on wgmma (about 21-bit products; small x small is dropped).  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/nerf_mlp.cu``'s ``nerf_fwd_tf32_kernel`` with the weight
    stream ``tf32_stack`` builds per call."""
    if x.device.type == "cpu":
        return nerf_mlp_fwd_tf32_plain(x, w)
    n = _check_rows(x, "x", IN_PAD)
    wp = _check_weights(w, False, x.device)
    out = torch.empty((n, OUT_PAD), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stack = tf32_stack(w)
        _raise_on(_lib().nerf_mlp_fwd_tf32(
            x.data_ptr(), wp, stack.data_ptr(), out.data_ptr(), n,
            _stream(x.device)), "nerf_mlp_fwd_tf32")
    nerf_mlp_fwd_tf32.launches += 1
    return out


nerf_mlp_fwd_tf32.launches = 0


def grad_tasks() -> list:
    """The dW/db task table of K2's and K5's split-K pass, one row per
    packed parameter: (act column or -1 for a column of ones, rows M, delta
    column, cols N, offset in the flat gradient buffer)."""
    rows = []
    for k in PACK_KEYS:
        act, delta = GRAD_PAIRS[k]
        m, n = PACK_SHAPES[k]
        d0, d1 = DELTA_OFFS[delta]
        assert d1 - d0 == n, k
        a0 = -1 if act is None else ACT_OFFS[act][0]
        rows.append((a0, m, d0, n, GRAD_OFFS[k][0]))
    return rows


_TASKS = [v for row in grad_tasks() for v in row]
SCRATCH_BYTES = 2 ** 31  # K5's workspaces


def macs_per_point() -> dict:
    """Multiply-adds per point of each kernel's work (unpadded layers): the
    forward ("fwd": K1, K3, K6), K2's delta chain and dW ("bwd_saved"), the
    delta chain alone ("deltas"), K5's recomputed forward and K2's work
    ("bwd"), and K4's products ("dx")."""
    layers = [(60, 256)] + [(256, 256)] * 4 + [(316, 256)] + [(256, 256)] * 2 \
        + [(256, 1), (256, 256), (280, 128), (128, 3)]
    fwd = sum(i * o for i, o in layers)
    # dW for every layer (the forward's MACs again), delta @ W^T for every
    # layer whose input is an activation (not a PE), and the two heads
    # rebuilt from h7/h9
    chain = (4 * 256 * 256 + 256 * 256 + 2 * 256 * 256 + 256 * 1
             + 256 * 256 + 256 * 128 + 128 * 3)
    heads = 256 + 128 * 3  # sigma and rgb rebuilt from h7 and h9
    saved = fwd + chain + heads
    return {"fwd": fwd, "bwd_saved": saved, "bwd": fwd + saved,
            "deltas": chain + heads, "dx": 2 * 60 * HID + 24 * RGB_HID}


def bwd_splits(n: int) -> int:
    """Point ranges the split-K dW pass splits the points into."""
    return max(1, min(16, n // 4096))


def chunk_rows(n: int, bf16: bool) -> int:
    """Points per pass of K5: whole splits of the split-K pass over all n
    points (as ``tile_mm.cuh``'s ``chunks_per_split`` cuts them) and a
    multiple of ``ROW_MULT``, its workspaces within ``SCRATCH_BYTES`` (or
    one split when a split alone is larger)."""
    splits = bwd_splits(n)
    per_split = DW.chunks_per_split(n, splits) * DW.PK
    unit = math.lcm(per_split, ROW_MULT)
    per_pt = (ACT_PAD + DELTA_W) * (2 if bf16 else 4)
    return min(n, max(unit, SCRATCH_BYTES // per_pt // unit * unit))


def _split_grads(dw):
    return [dw[GRAD_OFFS[k][0]:GRAD_OFFS[k][1]].view(PACK_SHAPES[k])
            for k in PACK_KEYS]


def _pe_deltas(deltas, offs):
    return tuple(deltas[:, offs[k][0]:offs[k][1]]
                 for k in ("dh9", "dh5", "dh0"))


def nerf_mlp_deltas(w: list, dy: torch.Tensor, acts: torch.Tensor,
                    bf16: bool = True) -> torch.Tensor:
    """K2's delta chain alone (its part (a)): the delta workspace ``[N,
    DELTA_W]`` from the saved activations, as ``nerf_mlp_deltas_plain``.
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/nerf_mlp.cu``.  ``launches`` also counts the delta kernels that
    K2 and K5 launch."""
    if dy.device.type == "cpu":
        return nerf_mlp_deltas_plain(w, dy, acts, bf16)
    n = _check_rows(dy, "dy", OUT_PAD)
    dev = dy.device
    act_dt = torch.bfloat16 if bf16 else torch.float32
    _check(acts, "acts", (n, ACT_PAD), act_dt, dev)
    wp = _check_weights(w, bf16, dev)
    deltas = torch.empty((n, DELTA_W), dtype=act_dt, device=dev)
    with torch.cuda.device(dev):
        stack = _bwd_stack(w) if bf16 else None
        _raise_on(_lib().nerf_mlp_deltas(
            wp, _ptr(stack), dy.data_ptr(), acts.data_ptr(),
            deltas.data_ptr(), n, int(bf16), _stream(dev)), "nerf_mlp_deltas")
    nerf_mlp_deltas.launches += 1
    return deltas


nerf_mlp_deltas.launches = 0


def nerf_mlp_bwd_saved(w: list, dy: torch.Tensor, acts: torch.Tensor,
                       bf16: bool = True):
    """K2: (the 26 parameter gradients, fp32, packed shapes, ``PACK_KEYS``
    order; the deltas ``(dh9, dh5, dh0)``, views of its workspace) from the
    saved activations.  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/nerf_mlp.cu`` (deltas, split dW partials, fixed-order sum:
    bitwise reproducible)."""
    if dy.device.type == "cpu":
        return nerf_mlp_bwd_saved_plain(w, dy, acts, bf16)
    n = _check_rows(dy, "dy", OUT_PAD)
    dev = dy.device
    act_dt = torch.bfloat16 if bf16 else torch.float32
    _check(acts, "acts", (n, ACT_PAD), act_dt, dev)
    wp = _check_weights(w, bf16, dev)
    splits = bwd_splits(n)
    deltas = torch.empty((n, DELTA_W), dtype=act_dt, device=dev)
    partials = torch.empty((splits, GRAD_TOTAL), dtype=torch.float32,
                           device=dev)
    dw = torch.empty(GRAD_TOTAL, dtype=torch.float32, device=dev)
    tasks = (ctypes.c_int * len(_TASKS))(*_TASKS)
    with torch.cuda.device(dev):
        stack = _bwd_stack(w) if bf16 else None
        _raise_on(_lib().nerf_mlp_bwd_saved(
            wp, _ptr(stack), dy.data_ptr(), acts.data_ptr(),
            deltas.data_ptr(), partials.data_ptr(), dw.data_ptr(), n, splits,
            tasks, len(PACK_KEYS), int(bf16), _stream(dev)),
            "nerf_mlp_bwd_saved")
    nerf_mlp_bwd_saved.launches += 1
    nerf_mlp_deltas.launches += 1       # its delta chain
    DW.dw_splitk.launches += int(bf16)  # its split-K pass (fp32: FMA tiles)
    return _split_grads(dw), _pe_deltas(deltas, DELTA_OFFS)


nerf_mlp_bwd_saved.launches = 0


def nerf_mlp_bwd(x: torch.Tensor, w: list, dy: torch.Tensor,
                 bf16: bool = True, need_dx: bool = True):
    """K5, the backward that recomputes the forward: (the 26 parameter
    gradients as K2 returns them; the deltas ``(dh9, dh5, dh0)`` when
    ``need_dx`` else None).  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/nerf_mlp.cu`` over chunks of ``chunk_rows``
    points (bf16: K1's forward kernel, then K2's delta kernel, then the
    split-K pass, per chunk): dW/db bitwise equal to K1 then K2 on the same
    inputs."""
    if x.device.type == "cpu":
        return nerf_mlp_bwd_plain(x, w, dy, bf16, need_dx)
    n = _check_rows(x, "x", IN_PAD)
    dev = x.device
    _check(dy, "dy", (n, OUT_PAD), torch.float32, dev)
    wp = _check_weights(w, bf16, dev)
    dt = torch.bfloat16 if bf16 else torch.float32
    splits, rows = bwd_splits(n), chunk_rows(n, bf16)
    acts = torch.empty((rows, ACT_PAD), dtype=dt, device=dev)
    deltas = torch.empty((rows, DELTA_W), dtype=dt, device=dev)
    pe = (torch.empty((n, PE_DELTA_W), dtype=dt, device=dev) if need_dx
          else None)
    partials = torch.empty((splits, GRAD_TOTAL), dtype=torch.float32,
                           device=dev)
    dw = torch.empty(GRAD_TOTAL, dtype=torch.float32, device=dev)
    tasks = (ctypes.c_int * len(_TASKS))(*_TASKS)
    with torch.cuda.device(dev):
        fwd_stack, bwd_stack = weight_stacks(w) if bf16 else (None, None)
        _raise_on(_lib().nerf_mlp_bwd(
            x.data_ptr(), wp, _ptr(fwd_stack), _ptr(bwd_stack),
            dy.data_ptr(), acts.data_ptr(), deltas.data_ptr(), rows,
            _ptr(pe), partials.data_ptr(), dw.data_ptr(), n, splits, tasks,
            len(PACK_KEYS), int(bf16), _stream(dev)), "nerf_mlp_bwd")
    nerf_mlp_bwd.launches += 1
    chunks = -(-n // rows) if bf16 else 0  # fp32: one fused kernel per chunk
    nerf_mlp_deltas.launches += chunks     # the delta chain of each chunk
    DW.dw_splitk.launches += chunks        # and its split-K pass
    return _split_grads(dw), (_pe_deltas(pe, PE_DELTA_OFFS) if need_dx
                              else None)


nerf_mlp_bwd.launches = 0


def nerf_mlp_dx(x: torch.Tensor, w: list, dh, bf16: bool = True):
    """K4: dx ``[N, 8]`` fp32 from x and the deltas ``(dh9, dh5, dh0)`` that
    K2 or K5 returned (column views sharing one row stride, 16-byte aligned
    rows).  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/nerf_mlp.cu``."""
    if x.device.type == "cpu":
        return nerf_mlp_dx_plain(x, w, dh, bf16)
    n = _check_rows(x, "x", IN_PAD)
    wp = _check_weights(w, bf16, x.device)
    dt = torch.bfloat16 if bf16 else torch.float32
    ld = dh[0].stride(0)
    for t, (name, width) in zip(dh, PE_DELTA_SLOTS):
        if (t.device != x.device or t.dtype != dt
                or tuple(t.shape) != (n, width) or t.stride() != (ld, 1)
                or (t.data_ptr() | ld * t.element_size()) % 16):
            raise ValueError(f"{name} must be a {dt} [{n}, {width}] view on "
                             f"{x.device} with row stride {ld}, its rows "
                             "16-byte aligned")
    dx = torch.empty((n, IN_PAD), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _raise_on(_lib().nerf_mlp_dx(
            x.data_ptr(), wp, *(t.data_ptr() for t in dh), ld, dx.data_ptr(),
            n, int(bf16), _stream(x.device)), "nerf_mlp_dx")
    nerf_mlp_dx.launches += 1
    return dx


nerf_mlp_dx.launches = 0

KERNELS = (nerf_mlp_fwd_save, nerf_mlp_bwd_saved, nerf_mlp_fwd,
           nerf_mlp_fwd_pipelined, nerf_mlp_bwd, nerf_mlp_dx,
           nerf_mlp_fwd_tf32)


def reset_launch_counts() -> None:
    """Every counter to 0: the kernels', and the delta chain's (counted
    apart, as the split-K pass is, since K2 and K5 launch it)."""
    for k in (*KERNELS, nerf_mlp_deltas):
        k.launches = 0


# ---------------------------------------------------------------------------
# Autograd: the custom VJP of fused_nerf_apply
# ---------------------------------------------------------------------------


class _FusedNeRFMLP(torch.autograd.Function):
    """Forward K1 (``save_acts``: the activations are the residuals) or K3
    (the residuals are x and the weights); backward K2 or K5, then K4 when
    ``need_dx`` (else zeros for x), as the JAX ``_fwd_rule``/``_bwd_rule``.
    ``w`` holds the packed weights as the kernels take them
    (``kernel_weights``); the gradients go to ``packed``."""

    @staticmethod
    def forward(ctx, x_pad, bf16, need_dx, save_acts, w, *packed):
        ctx.bf16, ctx.need_dx, ctx.save_acts = bf16, need_dx, save_acts
        if save_acts:
            with span("nerf_mlp.fwd_call"):
                out, acts = nerf_mlp_fwd_save(x_pad, w, bf16)
            ctx.save_for_backward(x_pad, acts, *w)
        else:
            out = nerf_mlp_fwd(x_pad, w, bf16)
            ctx.save_for_backward(x_pad, *w)
        return out

    @staticmethod
    def backward(ctx, dy):
        x_pad, *w = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.save_acts:
            acts, *w = w
            with span("nerf_mlp.bwd_call"):
                grads, dh = nerf_mlp_bwd_saved(w, dy, acts, ctx.bf16)
        else:
            grads, dh = nerf_mlp_bwd(x_pad, w, dy, ctx.bf16, ctx.need_dx)
        if ctx.need_dx:
            dx = nerf_mlp_dx(x_pad, w, dh, ctx.bf16)
        else:
            dx = torch.zeros_like(x_pad) if ctx.needs_input_grad[0] else None
        return (dx, None, None, None, None, *grads)


def fused_nerf_apply(model, x: torch.Tensor, bf16: bool = True,
                     need_dx: bool = True, save_acts: bool = False):
    """``model(x)`` through the fused kernels (the JAX ``fused_nerf_apply``
    without ``interpret``): x ``[..., 6]`` -> ``[..., 4]``, differentiable
    in the model's parameters and in x.

    When autograd records (grad enabled and x or a parameter requires grad)
    the forward is K1 with ``save_acts`` (activations spilled for K2), else
    K3 (K5 recomputes them); the backward is K2 or K5, then K4 for x's
    gradient when ``need_dx``.  ``need_dx=False`` returns zeros for x's
    gradient: only for callers whose x carries no gradient (the train step:
    points built from ray data and detached depths).  When autograd does not
    record, the forward is K3 alone."""
    with span("nerf_mlp.weights"):
        packed = pack_nerf_params(model)
        tensors = [packed[k] for k in PACK_KEYS]
        x_pad = pad_points(x.float())
        with torch.no_grad():
            w = kernel_weights(tensors, bf16)
    if torch.is_grad_enabled() and (
            x_pad.requires_grad or any(t.requires_grad for t in tensors)):
        out = _FusedNeRFMLP.apply(x_pad, bf16, need_dx, save_acts, w,
                                  *tensors)
    else:
        out = nerf_mlp_fwd(x_pad, w, bf16)
    n = x.numel() // x.shape[-1]
    return out[:n, :4].reshape(*x.shape[:-1], 4)


def takes_tf32_kernel(model, x: torch.Tensor) -> bool:
    """Whether ``model(x)`` goes through ``nerf_forward_tf32``: x a non-empty
    CUDA float32 tensor, autograd not recording (grad disabled, or neither x
    nor a parameter requires grad), the model the PE variant at the
    kernel's widths (hidden 256, 10 position and 4 direction frequencies)."""
    cfg = model.cfg
    return (x.is_cuda and x.dtype == torch.float32 and x.numel() > 0
            and not cfg.use_siren
            and (cfg.hidden_dim, cfg.pe_pos_length, cfg.pe_dir_length)
            == (HID, 10, 4)
            and not (torch.is_grad_enabled() and (
                x.requires_grad
                or any(p.requires_grad for p in model.parameters()))))


def nerf_forward_tf32(model, x: torch.Tensor) -> torch.Tensor:
    """``model(x)`` (x ``[..., 6]`` -> ``[..., 4]``) through
    ``nerf_mlp_fwd_tf32``, its weights packed per call, as
    ``fused_nerf_apply`` packs them."""
    with span("nerf_mlp.weights"):
        packed = pack_nerf_params(model)
        w = kernel_weights([packed[k] for k in PACK_KEYS], False)
        x_pad = pad_points(x)
    with span("nerf_mlp.fwd_call"):
        out = nerf_mlp_fwd_tf32(x_pad, w)
    n = x.numel() // x.shape[-1]
    return out[:n, :4].reshape(*x.shape[:-1], 4)
