"""K4, the NeRF MLP's input gradient through the PE, as its bf16 kernel on
wgmma computes it (csrc/nerf_mlp.cu, "bf16: K4 on wgmma": dx_tc_kernel).

The kernel runs only on a card (``python3 chip_smoke.py`` holds it against
``nerf_mlp_dx_plain`` there).  Here its arithmetic and its layouts are
emulated from the CUDA source's own constants: the PE weights as TMA lays
them in shared memory and the wgmma descriptors read them back (K-major,
128-byte swizzle), the delta boxes streamed from either layout K4 reads
(K2's delta workspace, K5's copy), one fp32 sum of dh5's and dh0's products
into dpe_p, then the chain rule through the PE; and held against the JAX
package's need_dx dx, its Pallas kernel in interpret mode."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.ops.pallas import nerf_mlp as JK
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K
from msra_practice_project_tpu_torch.weights import state_dict_from_params

CSRC = os.path.join(os.path.dirname(K.__file__), "csrc")
N = 256              # points: two of the kernel's 128-point tiles
BOX = 64             # delta columns per TMA box (128 bytes of bf16)
SMEM_LIMIT = 232448  # shared memory a block can use on an H100
# The kernel's stream per tile, in order: (delta slot, box, PE weight whose
# transpose it multiplies, accumulator)
SCHEDULE = ([("dh5", b, "W5a", "pos") for b in range(4)]
            + [("dh0", b, "W0", "pos") for b in range(4)]
            + [("dh9", b, "W9b", "dir") for b in range(2)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _consts() -> dict:
    """The K4 section's constants of csrc/nerf_mlp.cu, evaluated from their
    own expressions (casts dropped) over the constants they name."""
    with open(os.path.join(CSRC, "nerf_mlp.cu")) as f:
        src = f.read()
    env = {"HID": K.HID, "RGB_HID": K.RGB_HID, "PE_POS": K.PE_POS,
           "PE_DIR": K.PE_DIR, "IN_PAD": K.IN_PAD, "DW_BOX": BOX,
           "TC_TILE": 64, "TC_WG": 128, "TC_A_BLOCK": 64 * 64 * 2}
    names = ["DX_TILE", "DX_BOX_BYTES", "DX_BOXES", "DX_STAGES", "DXW_W5A",
             "DXW_W0", "DXW_W9B", "DXW_BYTES", "DX_ST", "DX_ST_BYTES",
             "DX_CONSUMERS", "DX_THREADS", "DX_TC_SMEM"]
    for name in names:
        m = re.search(rf"\b{name} = ([^;,]+)[;,]", src)
        assert m, name
        expr = " ".join(re.sub(r"\((size_t|int)\)", "", m.group(1))
                        .replace("/", "//").split())
        env[name] = int(eval(expr, {}, dict(env)))
    return env


def _swizzle(addr):
    """Shared-memory address -> the address the 128-byte swizzle stores it
    at: the 16-byte chunk bits 4..6 XOR the 128-byte row bits 7..9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_box(img, dst, src, row0, col0, rows):
    """TMA's copy of a box of `rows` x 64 bf16 elements of the 2-D tensor
    `src` (from row0, col0) into the shared-memory image `img` (2-byte
    elements) at byte address dst, 128-byte swizzled."""
    r, c = np.meshgrid(np.arange(rows), np.arange(BOX), indexing="ij")
    img[_swizzle(dst + r * 128 + c * 2) // 2] = src[row0 + r, col0 + c]


def _kmajor(img, start, rows):
    """The [rows, 16] operand that a K-major 128-byte-swizzle wgmma
    descriptor at byte address start reads (8-row atoms 1,024 B apart, each
    row 128 B of the contraction)."""
    n, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    return img[_swizzle(start + (n // 8) * 1024 + (n % 8) * 128 + k * 2) // 2]


def _weights_image(c, w):
    """The kernel's resident weights: the producer's boxes of W5a, W0 (64
    rows each) and W9b (32 rows) into their regions, one box per 64 delta
    columns."""
    img = np.full(c["DXW_BYTES"] // 2, np.nan, np.float32)
    for key, rows in (("W5a", K.PE_POS), ("W0", K.PE_POS), ("W9b", K.PE_DIR)):
        base = c[{"W5a": "DXW_W5A", "W0": "DXW_W0", "W9b": "DXW_W9B"}[key]]
        wt = w[key]
        for b in range(wt.shape[1] // BOX):
            _tma_box(img, base + b * rows * 128, wt, 0, b * BOX, rows)
    return img


def _b_operand(c, img, key, box, kk):
    """B's [N, 16] slice (PE column n, delta column 64 box + 16 kk + k) that
    the kernel's product reads for a stage of `key`."""
    rows = K.PE_DIR if key == "W9b" else K.PE_POS
    base = c[{"W5a": "DXW_W5A", "W0": "DXW_W0", "W9b": "DXW_W9B"}[key]]
    return _kmajor(img, base + box * rows * 128 + kk * 32, rows)


def _layout(dh, layout):
    """(rows [N, width] bf16-valued fp32, {slot: first column}): dh9, dh5
    and dh0 placed as K2's delta workspace (DELTA_SLOTS, 2448 columns) or
    as K5's copy (640) holds them."""
    offs, width = ((K.DELTA_OFFS, K.DELTA_W) if layout == "k2_workspace"
                   else (K.PE_DELTA_OFFS, K.PE_DELTA_W))
    rows = np.zeros((dh[0].shape[0], width), np.float32)
    for name, t in zip(("dh9", "dh5", "dh0"), dh):
        rows[:, offs[name][0]:offs[name][1]] = t
    return rows, {k: offs[k][0] for k in ("dh9", "dh5", "dh0")}


def _emulate(c, x, w, dh, layout):
    """dx [N, 8] as dx_tc_kernel computes it: per 128-point tile and stage
    the delta box into the ring, each warpgroup's 64 rows times the resident
    B by the descriptors, summed in fp32 into dpe_p (dh5's boxes, then
    dh0's) and dpe_d; then dx[r, c] = sum_f 2^f (dpe[6f + c] cos(2^f x) -
    dpe[6f + 3 + c] sin(2^f x)), f = 0 up, in fp32."""
    wimg = _weights_image(c, w)
    rows, col0 = _layout(dh, layout)
    n = x.shape[0]
    dpe = np.zeros((n, K.PE_POS + K.PE_DIR), np.float32)
    ring = np.zeros(c["DX_BOX_BYTES"] // 2, np.float32)
    for t in range(n // c["DX_TILE"]):
        acc = {wg: {"pos": np.zeros((64, K.PE_POS), np.float32),
                    "dir": np.zeros((64, K.PE_DIR), np.float32)}
               for wg in range(2)}
        for slot, box, key, which in SCHEDULE:
            ring[:] = np.nan
            _tma_box(ring, 0, rows, t * c["DX_TILE"], col0[slot] + box * BOX,
                     c["DX_TILE"])
            for wg in range(2):
                for kk in range(BOX // 16):
                    a = _kmajor(ring, wg * 64 * 128 + kk * 32, 64)
                    b = _b_operand(c, wimg, key, box, kk)
                    acc[wg][which] += a @ b.T
        for wg in range(2):
            r0 = t * c["DX_TILE"] + wg * 64
            dpe[r0:r0 + 64] = np.concatenate(
                [acc[wg]["pos"], acc[wg]["dir"]], axis=1)
    dx = np.zeros((n, K.IN_PAD), np.float32)
    for col in range(6):
        pos = col < 3
        d = col if pos else col - 3
        base = 0 if pos else K.PE_POS
        g = np.zeros(n, np.float32)
        for f in range(10 if pos else 4):
            sc = np.float32(2.0 ** f)
            a = x[:, col] * sc
            g = g + sc * (dpe[:, base + 6 * f + d] * np.cos(a)
                          - dpe[:, base + 6 * f + 3 + d] * np.sin(a))
        dx[:, col] = g
    return dx


@pytest.fixture(scope="module")
def case():
    """Inputs from numpy seeds, the JAX params with non-zero biases and the
    port's packed bf16 weights of the same values, the bf16 deltas (dh9,
    dh5, dh0) of the port's plain K5, and JAX's need_dx dx in bf16."""
    p = jnerf_model(False).init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(11)
    p = jax.tree_util.tree_map(
        lambda a: (jnp.asarray(rng.uniform(-0.1, 0.1, a.shape), jnp.float32)
                   if a.ndim == 1 else a), p)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    x[:, :3] *= 2.0
    x[:, 3:] /= np.linalg.norm(x[:, 3:], axis=1, keepdims=True)
    dy = (rng.normal(size=(N, K.OUT_PAD)) * 1e-2).astype(np.float32)
    dy[:, 4:] = 0
    m = nerf_model()
    m.load_state_dict(state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, p)))
    packed = K.pack_nerf_params(m)
    wk = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], True)
    xp = K.pad_points(torch.from_numpy(x))
    dh = K.nerf_mlp_bwd_plain(xp, wk, torch.from_numpy(dy), True, True)[1]
    jw, jx, n, _ = JK._prep(p, jnp.asarray(x), True)
    jdx, _ = JK._fused_backward(jx[:N], jw, jnp.asarray(dy), bf16=True,
                                interpret=True, need_dx=True, tile=128)
    return {"p": p, "x": xp.numpy(), "w": dict(zip(K.PACK_KEYS, wk)),
            "wk": wk, "dh": tuple(t.float().numpy() for t in dh),
            "dh_t": dh, "jdx": np.asarray(jdx)[:n]}


@pytest.mark.parametrize("layout", ["k2_workspace", "k5_copy"])
def test_emulated_kernel_matches_jax_need_dx(case, layout):
    """The kernel's arithmetic through its layouts, on deltas in either
    layout, against JAX's need_dx dx at the bf16 gate (5e-2 relative
    Frobenius) and against the port's plain K4 on the same deltas (only
    the fp32 sum order differs: 1e-5); the two layouts give the same
    emulated dx bitwise."""
    c = _consts()
    w = {k: v.float().numpy() for k, v in case["w"].items()}
    got = _emulate(c, case["x"], w, case["dh"], layout)
    other = _emulate(c, case["x"], w, case["dh"],
                     "k5_copy" if layout == "k2_workspace" else
                     "k2_workspace")
    np.testing.assert_array_equal(got, other)
    assert np.isfinite(got).all() and not got[:, 6:].any()
    ref = case["jdx"]
    assert float(np.abs(ref).max()) > 0
    rel = np.linalg.norm(got[:, :6] - ref[:, :6]) / np.linalg.norm(ref)
    assert rel <= 5e-2, rel
    plain = K.nerf_mlp_dx_plain(torch.from_numpy(case["x"]), case["wk"],
                                case["dh_t"], True).numpy()
    rel_plain = np.linalg.norm(got - plain) / np.linalg.norm(plain)
    assert rel_plain <= 1e-5, rel_plain


@pytest.mark.parametrize("key", ["W5a", "W0", "W9b"])
def test_resident_weights_are_jax_packed_weights_k_major(case, key):
    """The PE weight blocks as the kernel lays them out and its descriptors
    read them back: B[k, n] (delta column k, PE column n) is JAX's packed
    W[n, k] in bf16, with the packing's zero rows (60..63 of W5a and W0,
    24..31 of W9b), every byte of the region written once."""
    c = _consts()
    w = {k: v.float().numpy() for k, v in case["w"].items()}
    img = _weights_image(c, w)
    assert not np.isnan(img).any()
    ref = np.array(JK.pack_nerf_params(case["p"])[key], np.float32)
    ref = torch.from_numpy(ref).bfloat16().float().numpy()
    kdim = ref.shape[1]
    got = np.concatenate([_b_operand(c, img, key, k0 // BOX, kk)
                          for k0 in range(0, kdim, BOX)
                          for kk in range(BOX // 16)], axis=1)
    np.testing.assert_array_equal(got, ref)
    used = 60 if key != "W9b" else 24
    assert not got[used:].any() and got[:used].any()


def test_tile_stage_and_shared_memory_constants_match_python():
    """The kernel's tile, ring, weight regions and shared memory as the
    CUDA source sets them: 128-point tiles (ROW_MULT), 10 boxes of 128
    points x 64 columns per tile, the weight regions 1,024-byte aligned
    (swizzle atoms) and the whole within a block's shared memory with at
    least 3 stages."""
    c = _consts()
    assert c["DX_TILE"] == K.ROW_MULT == 2 * 64
    assert c["DX_BOXES"] == len(SCHEDULE) == 10
    assert c["DX_BOX_BYTES"] == c["DX_TILE"] * BOX * 2
    assert (c["DXW_W5A"], c["DXW_W0"], c["DXW_W9B"]) == (0, 32768, 65536)
    assert c["DXW_BYTES"] == 73728
    for off in (c["DXW_W5A"], c["DXW_W0"], c["DXW_W9B"], c["DXW_BYTES"],
                c["DX_BOX_BYTES"]):
        assert off % 1024 == 0
    assert c["DX_ST"] >= K.PE_POS + K.PE_DIR and c["DX_ST"] % 2 == 0
    assert c["DX_THREADS"] == c["DX_CONSUMERS"] + 32 == 288
    smem = (1024 + c["DXW_BYTES"] + c["DX_STAGES"] * c["DX_BOX_BYTES"]
            + 2 * 64 * c["DX_ST"] * 4 + (1 + 2 * c["DX_STAGES"]) * 8)
    assert c["DX_TC_SMEM"] == smem <= SMEM_LIMIT
    assert c["DX_STAGES"] >= 3


@pytest.mark.parametrize("layout", ["k2_workspace", "k5_copy"])
def test_delta_boxes_lie_inside_their_slots_at_aligned_columns(layout):
    """Every box the kernel streams lies inside its slot of the layout's
    row, starts 16-byte aligned (as TMA needs) and the tile's boxes read
    each of the 640 delta columns once; the view's row stride is a
    multiple of 16 bytes."""
    offs, width = ((K.DELTA_OFFS, K.DELTA_W) if layout == "k2_workspace"
                   else (K.PE_DELTA_OFFS, K.PE_DELTA_W))
    assert (width * 2) % 16 == 0
    cols = []
    for slot, box, _, _ in SCHEDULE:
        lo, hi = offs[slot]
        c0 = lo + box * BOX
        assert (c0 * 2) % 16 == 0 and c0 + BOX <= hi <= width
        cols.extend(range(c0, c0 + BOX))
    want = [c for s in ("dh9", "dh5", "dh0") for c in range(*offs[s])]
    assert sorted(cols) == sorted(want) and len(cols) == K.PE_DELTA_W


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch(case):
    """On CPU tensors nerf_mlp_dx is nerf_mlp_dx_plain, bitwise, and no
    kernel launch is counted."""
    before = K.nerf_mlp_dx.launches
    x = torch.from_numpy(case["x"])
    got = K.nerf_mlp_dx(x, case["wk"], case["dh_t"], True)
    want = K.nerf_mlp_dx_plain(x, case["wk"], case["dh_t"], True)
    assert torch.equal(got, want)
    assert K.nerf_mlp_dx.launches == before
