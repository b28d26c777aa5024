"""Layouts and schedules of the NeRF MLP's bf16 kernels on wgmma
(csrc/nerf_mlp.cu, "bf16: the forward and the delta chain on wgmma") that the
Python wrapper builds or mirrors: the two weight stacks their TMA stream
reads, each kernel's product schedule (emulated here slice by slice, with
the kernel's rounding points, against the plain versions), and the TMA
boxes of the spill and the delta workspaces.  The kernels themselves run
only on a card (``python3 chip_smoke.py``)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.ops.pallas import nerf_mlp as JK
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K
from msra_practice_project_tpu_torch.weights import state_dict_from_params

CSRC = os.path.join(os.path.dirname(K.__file__), "csrc")
N = 256          # points: two CTAs of the kernels' 64-point tiles
STAGE_ROWS = 32  # weight rows per ring stage
TMA_BOX = 64     # columns per TMA box (128 bytes of bf16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared():
    """JAX params with non-zero biases, and the port's packed weights from
    the same values."""
    p = jnerf_model(False).init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(5)
    p = jax.tree_util.tree_map(
        lambda a: (jnp.asarray(rng.uniform(-0.1, 0.1, a.shape), jnp.float32)
                   if a.ndim == 1 else a), p)
    m = nerf_model()
    m.load_state_dict(state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, p)))
    packed = K.pack_nerf_params(m)
    return p, [packed[k].detach() for k in K.PACK_KEYS]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    x[:, :3] *= 2.0
    x[:, 3:] /= np.linalg.norm(x[:, 3:], axis=1, keepdims=True)
    dy = rng.normal(size=(N, K.OUT_PAD)).astype(np.float32) * 1e-2
    dy[:, 4:] = 0
    return K.pad_points(torch.from_numpy(x)), torch.from_numpy(dy)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_weight_stacks_hold_each_products_weights_in_stream_order(
        shared, direction):
    """Forward product p reads rows [start, start + K) of the forward stack:
    its weight zero-padded to 256 columns (W9a, W9b), with the zero rows of
    pack_nerf_params (W0, W5a, W9b); backward product p reads its weight
    transposed.  Held against the JAX package's packed weights."""
    p, w = shared
    ref = {k: np.asarray(v, np.float32)
           for k, v in JK.pack_nerf_params(p).items()}
    stacks = dict(zip(("fwd", "bwd"), K.weight_stacks(
        K.kernel_weights(w, True))))
    stack = stacks[direction]
    sched = K.FWD_SCHEDULE if direction == "fwd" else K.BWD_SCHEDULE
    assert stack.dtype == torch.bfloat16 and stack.is_contiguous()
    row = 0
    for key, _, _ in sched:
        want = ref[key] if direction == "fwd" else ref[key].T
        rows = want.shape[0]
        assert rows % STAGE_ROWS == 0, key
        want = np.pad(want, ((0, 0), (0, K.HID - want.shape[1])))
        got = stack[row:row + rows]
        assert torch.equal(got, torch.from_numpy(want).bfloat16()), key
        row += rows
    assert row == stack.shape[0] and stack.shape[1] == K.HID
    assert row == (2464 if direction == "fwd" else 2176)
    if direction == "fwd":
        starts = {}
        row = 0
        for key, _, _ in sched:
            starts[key] = row
            row += ref[key].shape[0]
        for key, used in (("W0", 60), ("W5a", 60), ("W9b", 24)):
            r0 = starts[key]
            assert not stack[r0 + used:r0 + ref[key].shape[0]].any(), key
        for key in ("W9a", "W9b"):
            r0 = starts[key]
            assert not stack[r0:r0 + ref[key].shape[0], K.RGB_HID:].any(), key


def test_stage_counts_and_offsets_match_the_cuda_source():
    """The kernels count ring stages and place workspace columns by their
    own constants: they must be the stacks' rows / 32 and the layout
    tables' offsets."""
    src = _source("nerf_mlp.cu")

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    fwd_rows = sum(K.PACK_SHAPES[k][0] for k, _, _ in K.FWD_SCHEDULE)
    bwd_rows = sum(K.PACK_SHAPES[k][1] for k, _, _ in K.BWD_SCHEDULE)
    assert const("NF_STAGES") * STAGE_ROWS == fwd_rows
    assert const("NB_STAGES") * STAGE_ROWS == bwd_rows
    assert const("A_H0") == K.ACT_OFFS["h0"][0]
    assert const("D_DH9") == K.DELTA_OFFS["dh9"][0]
    assert const("D_DHD") == K.DELTA_OFFS["dhd"][0]
    assert const("D_DH7") == K.DELTA_OFFS["dh7"][0]
    # the stores and loads of the kernels, in the order they are issued
    assert re.search(r"tc_store_a\(c, &dmap, D_DH7 \+ \(7 - l\) \* HID\)",
                     src)
    assert "tc_load_tile(mask, &amap, A_H0 + (l - 1) * HID" in src


def _tma_boxes() -> dict:
    """The bf16 kernels' TMA boxes by the row they lie in: {row: (row width
    in elements, [(first column, 64-column boxes), ...])}: the spill's
    stores (K1) and loads (the delta chain's heads and masks), the delta
    workspace's stores and K5's copy of dh9 | dh5 | dh0, as the schedules
    place them."""
    def boxes(offs, names):
        return [(offs[k][0], (offs[k][1] - offs[k][0]) // TMA_BOX)
                for k in names]
    acts = [n for _, _, n in K.FWD_SCHEDULE if n is not None]
    masks = ["h9"] + [m for _, _, m in K.BWD_SCHEDULE if m is not None]
    deltas = ["dh9"] + [d for _, d, _ in K.BWD_SCHEDULE]
    return {"spill_stores": (K.ACT_PAD, boxes(K.ACT_OFFS, acts)),
            "spill_loads": (K.ACT_PAD, boxes(K.ACT_OFFS, masks)),
            "delta_stores": (K.DELTA_W, boxes(K.DELTA_OFFS, deltas)),
            "pe_delta_stores": (K.PE_DELTA_W, boxes(
                K.PE_DELTA_OFFS, ("dh9", "dh5", "dh0")))}


@pytest.mark.parametrize("table", ["spill_stores", "spill_loads",
                                   "delta_stores", "pe_delta_stores"])
def test_tma_boxes_lie_inside_their_rows_at_multiples_of_8(table):
    """Every box of 64 columns starts at a multiple of 8 elements (16 bytes,
    as TMA needs) and ends inside its row, and together they hold the slots
    the kernels move."""
    width, boxes = _tma_boxes()[table]
    for col0, n in boxes:
        assert col0 % 8 == 0 and n >= 1
        assert col0 + n * TMA_BOX <= width
    cols = sorted(c for col0, n in boxes
                  for c in range(col0, col0 + n * TMA_BOX))
    assert len(cols) == len(set(cols))
    want = {"spill_stores": K.ACT_W - K.PE_POS - K.PE_DIR,
            "spill_loads": K.ACT_W - K.PE_POS - K.PE_DIR - K.HID,  # not hd
            "delta_stores": K.DELTA_W - 2 * K.OUT_PAD,  # dr, dsig directly
            "pe_delta_stores": K.PE_DELTA_W}[table]
    assert len(cols) == want


def _fwd_emulated(x, w, bf16):
    """The forward kernel's schedule: the stack's 32-row slices in stream
    order, each times the matching 32 columns of its A (a PE block or the
    previous activation), summed in fp32 into one register set per layer
    (two products for h5 and h9); the epilogue adds the bias, applies relu
    (not to hd) and rounds to bf16 (when bf16); sigma and rgb from the
    rounded h7 and h9."""
    rnd = (lambda a: a.bfloat16().float()) if bf16 else (lambda a: a)
    d = dict(zip(K.PACK_KEYS, (t.float() for t in w)))
    stack = K.weight_stacks(w)[0].float()
    pe_p, pe_d = (rnd(t) for t in K._pe(x.float()))
    a = {"pe_p": pe_p, "pe_d": pe_d}
    bias = {f"h{i}": f"b{i}" for i in range(8)} | {"hd": "b8", "h9": "b9"}
    act, acc, row = None, None, 0
    for key, src, out in K.FWD_SCHEDULE:
        op = act if src == "act" else a[src]
        if acc is None:
            acc = torch.zeros(x.shape[0], K.HID)
        for r in range(0, K.PACK_SHAPES[key][0], STAGE_ROWS):
            acc = acc + op[:, r:r + STAGE_ROWS] @ stack[
                row + r:row + r + STAGE_ROWS]
        row += K.PACK_SHAPES[key][0]
        if out is None:
            continue
        b = d[bias[out]]
        v = acc[:, :b.shape[1]] + b
        act = a[out] = rnd(v if out == "hd" else torch.relu(v))
        acc = None
    sig = torch.relu(a["h7"] @ d["Ws"][:, :1] + d["bs"][:, :1])
    rgb = torch.sigmoid(a["h9"] @ d["Wr"][:, :3] + d["br"][:, :3])
    out = torch.cat([rgb, sig, torch.zeros(x.shape[0], 4)], dim=1)
    acts = F.pad(torch.cat([a[n] for n, _ in K.ACT_SLOTS], dim=1),
                 (0, K.ACT_PAD - K.ACT_W))
    return out, acts


def _deltas_emulated(w, dy, acts, bf16):
    """The delta kernel's schedule from the saved activations: the heads
    rebuilt from h7 and h9, dr and dsig rounded as stored, dh9 = (dr Wr^T)
    (h9 > 0); then the backward stack's 32-row slices in stream order, each
    times the matching 32 columns of the previous delta, summed in fp32;
    the epilogue adds dsig Ws^T (dh7), masks by the activation's relu and
    rounds to bf16 (when bf16).  Returns the delta workspace."""
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    d = dict(zip(K.PACK_KEYS, (t.float() for t in w)))
    stack = K.weight_stacks(w)[1].float()
    a = {n: acts[:, o0:o1].float() for n, (o0, o1) in K.ACT_OFFS.items()}
    sig = torch.relu(a["h7"] @ d["Ws"][:, :1] + d["bs"][:, :1])
    rgb = torch.sigmoid(a["h9"] @ d["Wr"][:, :3] + d["br"][:, :3])
    dr = rnd(dy[:, :3] * rgb * (1.0 - rgb))
    dsig = rnd(dy[:, 3:4] * (sig > 0).float())
    out = {"dr": F.pad(dr, (0, K.OUT_PAD - 3)),
           "dsig": F.pad(dsig, (0, K.OUT_PAD - 1)),
           "dh9": rnd((dr @ d["Wr"][:, :3].t()) * (a["h9"] > 0).float())}
    prev, row = out["dh9"], 0
    for key, name, mask in K.BWD_SCHEDULE:
        acc = torch.zeros(dy.shape[0], K.HID)
        for r in range(0, K.PACK_SHAPES[key][1], STAGE_ROWS):
            acc = acc + prev[:, r:r + STAGE_ROWS] @ stack[
                row + r:row + r + STAGE_ROWS]
        row += K.PACK_SHAPES[key][1]
        if name == "dh7":
            acc = acc + dsig * d["Ws"][:, 0][None]
        if mask is not None:
            acc = torch.where(a[mask] > 0, acc, 0.0)
        prev = out[name] = rnd(acc)
    return torch.cat([out[n] for n, _ in K.DELTA_SLOTS], dim=1)


def _close(got, ref, bf16, rel):
    if bf16:
        err = float((got - ref).norm() / ref.norm().clamp_min(1e-30))
        assert err <= rel, err
    else:
        tol = 1e-5 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("bf16", [False, True])
def test_forward_schedule_matches_fwd_save_plain(shared, bf16):
    """The forward kernel's product schedule against the plain K1: fp32
    within 1e-5 of max|ref|; bf16 within the card's gates (out 1e-3
    relative Frobenius and 5e-2 max abs, the spill 5e-2 relative
    Frobenius)."""
    _, w = shared
    wk = K.kernel_weights(w, bf16)
    x, _ = _inputs(0)
    out, acts = _fwd_emulated(x, wk, bf16)
    out_p, acts_p = K.nerf_mlp_fwd_save_plain(x, wk, bf16)
    _close(out, out_p, bf16, 1e-3)
    _close(acts, acts_p.float(), bf16, 5e-2)
    if bf16:
        assert float((out - out_p).abs().max()) <= 5e-2


@pytest.mark.parametrize("bf16", [False, True])
def test_delta_schedule_matches_deltas_plain(shared, bf16):
    """The delta kernel's product schedule against K2's plain delta
    workspace on the same saved activations: fp32 within 1e-5 of max|ref|
    per slot; bf16 within 5e-2 relative Frobenius per slot (K2's gate)."""
    _, w = shared
    wk = K.kernel_weights(w, bf16)
    x, dy = _inputs(1)
    _, acts = K.nerf_mlp_fwd_save_plain(x, wk, bf16)
    got = _deltas_emulated(wk, dy, acts, bf16)
    ref = K.nerf_mlp_deltas_plain(wk, dy, acts, bf16).float()
    for name, (o0, o1) in K.DELTA_OFFS.items():
        if float(ref[:, o0:o1].abs().max()) > 0:
            _close(got[:, o0:o1], ref[:, o0:o1], bf16, 5e-2)
        else:
            assert not got[:, o0:o1].any(), name


def test_cpu_delta_wrapper_takes_the_plain_version_and_counts_no_launch(
        shared):
    _, w = shared
    wk = K.kernel_weights(w, True)
    x, dy = _inputs(2)
    _, acts = K.nerf_mlp_fwd_save_plain(x, wk, True)
    K.reset_launch_counts()
    got = K.nerf_mlp_deltas(wk, dy, acts, True)
    assert torch.equal(got, K.nerf_mlp_deltas_plain(wk, dy, acts, True))
    assert K.nerf_mlp_deltas.launches == 0
    K.nerf_mlp_deltas.launches = 3
    K.reset_launch_counts()
    assert K.nerf_mlp_deltas.launches == 0
