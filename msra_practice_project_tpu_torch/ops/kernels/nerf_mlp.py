"""Fused NeRF MLP for the train step: forward that saves activations (K1) and
backward from those activations (K2), with ``need_dx=False``.

Port of ``msra_practice_project_tpu/ops/pallas/nerf_mlp.py``: K1 replaces
``_fwd_save_kernel`` (launched by ``_fused_forward_save``), K2 replaces
``_bwd_saved_kernel`` + ``_grad_body`` (launched by ``_fused_backward_saved``).
The CUDA kernels are ``csrc/nerf_mlp.cu``; the source notes there give the
bound on an H100 and the design.

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
  ``pack_nerf_params``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...core.nn import positional_encoding

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


def nerf_mlp_fwd_save_plain(x: torch.Tensor, w: list, bf16: bool):
    """Plain version of K1: (out ``[N, 8]`` fp32, acts ``[N, 2560]``, bf16
    when ``bf16`` else fp32)."""
    w = dict(zip(PACK_KEYS, (t.float() for t in w)))
    st = (lambda a: _round(a, bf16))
    relu = torch.relu
    a = {}
    pe_p, pe_d = _pe(x.float())
    a["pe_p"], a["pe_d"] = st(pe_p), st(pe_d)
    h = a["pe_p"]
    for i in range(5):
        h = a[f"h{i}"] = st(relu(_mm(h, w[f"W{i}"], bf16) + w[f"b{i}"]))
    h = a["h5"] = st(relu(_mm(a["pe_p"], w["W5a"], bf16)
                          + _mm(h, w["W5b"], bf16) + w["b5"]))
    for i in (6, 7):
        h = a[f"h{i}"] = st(relu(_mm(h, w[f"W{i}"], bf16) + w[f"b{i}"]))
    sig = relu(_mm(h, w["Ws"], bf16) + w["bs"])
    a["hd"] = st(_mm(h, w["W8"], bf16) + w["b8"])
    a["h9"] = st(relu(_mm(a["hd"], w["W9a"], bf16)
                      + _mm(a["pe_d"], w["W9b"], bf16) + w["b9"]))
    rgb = torch.sigmoid(_mm(a["h9"], w["Wr"], bf16) + w["br"])
    out = torch.cat([rgb[:, :3], sig[:, :1],
                     rgb.new_zeros(rgb.shape[0], OUT_PAD - 4)], dim=1)
    dt = torch.bfloat16 if bf16 else torch.float32
    acts = torch.cat([a[name] for name, _ in ACT_SLOTS], dim=1)
    acts = F.pad(acts, (0, ACT_PAD - ACT_W)).to(dt)
    return out, acts


def nerf_mlp_bwd_saved_plain(w: list, dy: torch.Tensor, acts: torch.Tensor,
                             bf16: bool) -> list:
    """Plain version of K2 (``_grad_body`` with ``need_dx=False``): the 26
    parameter gradients, fp32, in ``PACK_KEYS`` order and packed shapes."""
    w = dict(zip(PACK_KEYS, (t.float() for t in w)))
    acts = acts.float()
    a = {name: acts[:, o0:o1] for name, (o0, o1) in ACT_OFFS.items()}
    g = {}

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

    dr_pre = drgb * rgb * (1.0 - rgb)
    acc("Wr", "br", a["h9"], dr_pre)
    dh9 = mmB(dr_pre, w["Wr"]) * mask(a["h9"])
    acc("W9a", "b9", a["hd"], dh9)
    acc("W9b", None, a["pe_d"], dh9)
    dhd = mmB(dh9, w["W9a"])
    acc("Ws", "bs", a["h7"], dsig)
    acc("W8", "b8", a["h7"], dhd)
    dh = (mmB(dsig, w["Ws"]) + mmB(dhd, w["W8"])) * mask(a["h7"])
    acc("W7", "b7", a["h6"], dh)
    dh = mmB(dh, w["W7"]) * mask(a["h6"])
    acc("W6", "b6", a["h5"], dh)
    dh5 = mmB(dh, w["W6"]) * mask(a["h5"])
    acc("W5a", None, a["pe_p"], dh5)
    acc("W5b", "b5", a["h4"], dh5)
    dh = mmB(dh5, w["W5b"]) * mask(a["h4"])
    for i in (4, 3, 2, 1):
        acc(f"W{i}", f"b{i}", a[f"h{i - 1}"], dh)
        dh = mmB(dh, w[f"W{i}"]) * mask(a[f"h{i - 1}"])
    acc("W0", "b0", a["pe_p"], dh)
    return [g[k] for k in PACK_KEYS]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    from .build import load

    lib = load("nerf_mlp")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nerf_mlp_fwd_save.argtypes = [p, ctypes.POINTER(p), p, p, i, i, p]
        lib.nerf_mlp_fwd_save.restype = i
        lib.nerf_mlp_bwd_saved.argtypes = [
            ctypes.POINTER(p), p, p, p, p, p, i, i,
            ctypes.POINTER(ctypes.c_int), i, i, p]
        lib.nerf_mlp_bwd_saved.restype = i
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


def nerf_mlp_fwd_save(x: torch.Tensor, w: list, bf16: bool = True):
    """K1: (out ``[N, 8]`` fp32, acts ``[N, 2560]``).  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/nerf_mlp.cu``."""
    if x.device.type == "cpu":
        return nerf_mlp_fwd_save_plain(x, w, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[0]
    if n % ROW_MULT:
        raise ValueError(f"point count {n} is not a multiple of {ROW_MULT}")
    _check(x, "x", (n, IN_PAD), torch.float32, x.device)
    wp = _check_weights(w, bf16, x.device)
    out = torch.empty((n, OUT_PAD), dtype=torch.float32, device=x.device)
    acts = torch.empty((n, ACT_PAD), device=x.device,
                       dtype=torch.bfloat16 if bf16 else torch.float32)
    with torch.cuda.device(x.device):
        err = _lib().nerf_mlp_fwd_save(
            x.data_ptr(), wp, out.data_ptr(), acts.data_ptr(), n, int(bf16),
            _stream(x.device))
    if err:
        raise RuntimeError(f"nerf_mlp_fwd_save launch failed: CUDA error {err}")
    nerf_mlp_fwd_save.launches += 1
    return out, acts


nerf_mlp_fwd_save.launches = 0


def grad_tasks() -> list:
    """K2's dW/db task table, one row per packed parameter:
    (act column or -1 for a column of ones, rows M, delta column, cols N,
    offset in the flat gradient buffer)."""
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


def bwd_splits(n: int) -> int:
    """Point ranges K2's dW pass splits the points into."""
    return max(1, min(16, n // 4096))


def nerf_mlp_bwd_saved(w: list, dy: torch.Tensor, acts: torch.Tensor,
                       bf16: bool = True) -> list:
    """K2: the 26 parameter gradients (fp32, packed shapes, ``PACK_KEYS``
    order) from the saved activations, no input gradient.  CPU tensors take
    the plain version; CUDA tensors launch ``csrc/nerf_mlp.cu`` (deltas,
    split dW partials, fixed-order sum: bitwise reproducible)."""
    if dy.device.type == "cpu":
        return nerf_mlp_bwd_saved_plain(w, dy, acts, bf16)
    if dy.device.type != "cuda":
        raise ValueError(f"unsupported device {dy.device}")
    n = dy.shape[0]
    if n % ROW_MULT:
        raise ValueError(f"point count {n} is not a multiple of {ROW_MULT}")
    dev = dy.device
    _check(dy, "dy", (n, OUT_PAD), torch.float32, dev)
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
        err = _lib().nerf_mlp_bwd_saved(
            wp, dy.data_ptr(), acts.data_ptr(), deltas.data_ptr(),
            partials.data_ptr(), dw.data_ptr(), n, splits, tasks,
            len(PACK_KEYS), int(bf16), _stream(dev))
    if err:
        raise RuntimeError(
            f"nerf_mlp_bwd_saved launch failed: CUDA error {err}")
    nerf_mlp_bwd_saved.launches += 1
    return [dw[GRAD_OFFS[k][0]:GRAD_OFFS[k][1]].view(PACK_SHAPES[k])
            for k in PACK_KEYS]


nerf_mlp_bwd_saved.launches = 0

KERNELS = (nerf_mlp_fwd_save, nerf_mlp_bwd_saved)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Autograd: the custom VJP of fused_nerf_apply (save_acts=True, need_dx=False)
# ---------------------------------------------------------------------------


class _FusedNeRFMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_pad, bf16, *packed):
        w = kernel_weights(packed, bf16)
        out, acts = nerf_mlp_fwd_save(x_pad, w, bf16)
        ctx.bf16 = bf16
        ctx.save_for_backward(acts, *w)
        return out

    @staticmethod
    def backward(ctx, dy):
        acts, *w = ctx.saved_tensors
        grads = nerf_mlp_bwd_saved(w, dy.contiguous(), acts, ctx.bf16)
        return (None, None, *grads)


def fused_nerf_apply(model, x: torch.Tensor, bf16: bool = True):
    """``model(x)`` through K1 (forward) and K2 (backward): x ``[..., 6]`` ->
    ``[..., 4]``, differentiable in the model's parameters only.  The input
    gradient (K4) is not ported, so ``x`` must not require grad."""
    if x.requires_grad:
        raise NotImplementedError(
            "fused_nerf_apply has no input gradient (need_dx=True is not "
            "ported); detach x")
    packed = pack_nerf_params(model)
    x_pad = pad_points(x.float())
    out = _FusedNeRFMLP.apply(x_pad, bf16, *(packed[k] for k in PACK_KEYS))
    n = x.numel() // x.shape[-1]
    return out[:n, :4].reshape(*x.shape[:-1], 4)
