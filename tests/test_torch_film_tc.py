"""Layouts of the bf16 per-tile pass of K7 and K8 (csrc/film_mlp.cu, "bf16:
the per-tile pass on wgmma") that the Python wrapper builds or mirrors: the
two weight stacks its TMA stream reads, the activation buffer's swizzled
address, and the map from CTAs to 64-point tiles.  The kernels themselves
run only on a card (``python3 chip_smoke.py``)."""

import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.models import pigan as jpigan
from msra_practice_project_tpu.ops.pallas import film_mlp as JK
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.ops.kernels import film_mlp as K
from msra_practice_project_tpu_torch.weights import state_dict_from_params

CSRC = os.path.join(os.path.dirname(K.__file__), "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("use_dir", [True, False])
def test_weight_stacks_hold_each_products_weights_in_stream_order(use_dir):
    """The producer reads stack rows (product * 256 + slice * 32): forward
    product p (layer p + 1) is W_{p+1} (W8a for p = 7), backward product p
    (from layer 8 - p) is that layer's weight transposed."""
    p = jpigan.FilmSirenNeRF(jpigan.FilmSirenNeRFConfig(use_dir=use_dir)).init(
        jax.random.PRNGKey(3))
    t = pigan.FilmSirenNeRF(pigan.FilmSirenNeRFConfig(use_dir=use_dir))
    t.load_state_dict(state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, p)))
    packed = K.pack_film_params(dict(t.named_parameters()), use_dir)
    w = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], True)
    fwd, bwd = K.weight_stacks(w)
    assert fwd.shape == bwd.shape == (8 * K.HID, K.HID)
    assert fwd.dtype == bwd.dtype == torch.bfloat16
    assert fwd.is_contiguous() and bwd.is_contiguous()
    ref = JK.pack_film_params(p, use_dir)
    layer_key = {l: f"W{l}" for l in range(1, 8)} | {8: "W8a"}
    for prod in range(8):
        want_f = np.asarray(ref[layer_key[prod + 1]]).astype(np.float32)
        want_b = np.asarray(ref[layer_key[8 - prod]]).astype(np.float32).T
        rows = slice(prod * K.HID, (prod + 1) * K.HID)
        bf = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
        assert torch.equal(fwd[rows], bf(want_f)), prod
        assert torch.equal(bwd[rows], bf(want_b)), prod


@pytest.mark.parametrize("use_dir", [True, False])
def test_tf32_stack_holds_each_products_weights_transposed_in_stream_order(
        use_dir):
    """The fp32 K8's producer reads rows (half * 2048 + product * 256 + n)
    of the tf32 stack: product p (layer p + 1, W8a for p = 7) as W^T, output
    column n's 256 inputs in one row (K-major); half 0 = W^T rounded to tf32
    (the low 13 bits zero), half 1 = the remainder, the two summing to W^T
    exactly."""
    p = jpigan.FilmSirenNeRF(jpigan.FilmSirenNeRFConfig(use_dir=use_dir)).init(
        jax.random.PRNGKey(4))
    t = pigan.FilmSirenNeRF(pigan.FilmSirenNeRFConfig(use_dir=use_dir))
    t.load_state_dict(state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, p)))
    packed = K.pack_film_params(dict(t.named_parameters()), use_dir)
    w = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], False)
    stack = K.tf32_stack(w)
    assert stack.shape == (2 * 8 * K.HID, K.HID)
    assert stack.dtype == torch.float32 and stack.is_contiguous()
    big, small = stack[:8 * K.HID], stack[8 * K.HID:]
    assert not (big.view(torch.int32) & 0x1FFF).any()
    ref = JK.pack_film_params(p, use_dir)
    layer_key = {l: f"W{l}" for l in range(1, 8)} | {8: "W8a"}
    for prod in range(8):
        want = np.ascontiguousarray(
            np.asarray(ref[layer_key[prod + 1]]).astype(np.float32).T)
        rows = slice(prod * K.HID, (prod + 1) * K.HID)
        np.testing.assert_array_equal((big[rows] + small[rows]).numpy(), want)
        # big is the nearest tf32 value: within half a tf32 ulp of W
        ulp = np.exp2(np.floor(np.log2(np.abs(want) + 1e-38)) - 10)
        assert np.all(np.abs(small[rows].numpy()) <= ulp / 2), prod


def test_tf32_split_rounds_to_nearest_ties_away_like_cvt_rna():
    """cvt.rna.tf32.f32's rounding: to the nearest value with 10 mantissa
    bits, a tie (bit 12 set, bits 0-11 clear) away from zero, exactly."""
    one = 1.0
    ulp = 2.0 ** -10
    vals = np.array([one, one + ulp / 2, one + ulp / 2 + 2 ** -23,
                     one + ulp / 2 - 2 ** -23, one + 1.5 * ulp,
                     -(one + ulp / 2), 3.0e-30, -7.25, 0.0], dtype=np.float32)
    want = np.array([one, one + ulp, one + ulp, one, one + 2 * ulp,
                     -(one + ulp), None, -7.25, 0.0], dtype=object)
    big, small = K.tf32_split(torch.from_numpy(vals))
    for v, b, s, wv in zip(vals, big.numpy(), small.numpy(), want):
        assert np.float32(b) + np.float32(s) == v
        if wv is not None:
            assert b == np.float32(wv), (v, b, wv)
    assert not (big.view(torch.int32) & 0x1FFF).any()


def test_tf32_a_offset_is_the_128_byte_swizzle_and_a_bijection():
    """Point p's 32 fp32 columns of a block fill one 128-byte row
    (K-major), its 16-byte chunks permuted as TMA's 128-byte swizzle
    permutes them, each 8 KB block covered once; the CUDA source computes
    the same address and sizes."""
    p = np.arange(K.TF_TILE)[:, None]
    col = np.arange(K.HID)[None, :]
    got = np.vectorize(K.tf32_a_offset)(p, col)
    linear = (col // 32) * K.TF_A_BLOCK + p * 128 + (col % 32) * 4
    np.testing.assert_array_equal(got, linear ^ (((linear >> 7) & 7) << 4))
    assert K.TF_A_BLOCK == K.TF_TILE * 128 and K.TF_A_BLOCK % 1024 == 0
    np.testing.assert_array_equal(np.sort(got.ravel()),
                                  np.arange(0, 8 * K.TF_A_BLOCK, 4))
    src = _source("film_mlp.cu")
    assert ("return (col >> 5) * TF_A_BLOCK + p * 128 + ((((col >> 2) ^ p) "
            "& 7) << 4)\n         + (col & 3) * 4;") in src
    assert "TF_STAGE_BYTES = HID * TF_KS * 4;" in src
    assert "TF_A_BLOCK = TF_TILE * TF_KS * 4;" in src
    for name, v in (("TF_TILE", K.TF_TILE), ("TF_KS", 32)):
        assert re.search(rf"\b{name} = {v};", src), name


def test_a_buffer_offset_is_the_128_byte_swizzle_and_a_bijection():
    """Point p's 64 columns of a block fill one 128-byte row (K-major), the
    row's 16-byte chunks permuted as TMA's 128-byte swizzle permutes them
    (address bits 4-6 XOR bits 7-9), and each 8 KB block is covered once."""
    p = np.arange(K.TC_TILE)[:, None]
    col = np.arange(K.HID)[None, :]
    got = np.vectorize(K.a_buffer_offset)(p, col)
    linear = (col // 64) * K.TC_A_BLOCK + p * 128 + (col % 64) * 2
    np.testing.assert_array_equal(got, linear ^ (((linear >> 7) & 7) << 4))
    assert K.TC_A_BLOCK == K.TC_TILE * 128 and K.TC_A_BLOCK % 1024 == 0
    for blk in range(K.HID // 64):
        off = got[:, blk * 64:(blk + 1) * 64]
        np.testing.assert_array_equal(off // 128 - blk * K.TC_TILE,
                                      np.broadcast_to(p, off.shape))
        rel = np.sort((off - blk * K.TC_A_BLOCK).ravel())
        np.testing.assert_array_equal(rel, np.arange(0, K.TC_A_BLOCK, 2))
    # the CUDA source computes the same address
    assert re.search(r"return p \* 128 \+ \(\(\(\(col >> 3\) \^ p\) & 7\) "
                     r"<< 4\) \+ \(col & 7\) \* 2;", _source("tile_mm.cuh"))
    assert ("return (col >> 6) * TC_A_BLOCK + swizzled(p, col & 63);"
            in _source("tile_mm.cuh"))


# 15: chip_smoke.py's odd-tile shape (3 images of 320 points); 2304: a chunk
# of 6 images of 24,576 points (the G step's fine pass)
@pytest.mark.parametrize("n_tiles", [1, 2, 15, 128, 2304])
def test_cta_tiles_cover_every_tile_once(n_tiles):
    ctas = K.cta_tiles(n_tiles)
    assert len(ctas) == (n_tiles + 1) // 2
    seen = [t for pair in ctas for t in pair if t is not None]
    assert seen == list(range(n_tiles))
    idle = [i for i, (_, b) in enumerate(ctas) if b is None]
    assert idle == ([len(ctas) - 1] if n_tiles % 2 else [])


def test_film_probe_edits_apply_to_the_source():
    """tools/torch_film_probe.py's variants each change the CUDA source (an
    edit whose text went missing would raise), and the branchy one restores
    a branch in the sine's reflection."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_film_probe", os.path.join(root, "tools", "torch_film_probe.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = _source("film_mlp.cu")
    out = tool.variants(src)
    assert set(out) == set(tool.EDITS) and out["as_is"] == src
    assert all(out[k] != src for k in out if k != "as_is")
    assert src.count(tool._SELECT) == 1 and src.count(tool._JB) == 1
    assert src.count(tool._WALK) == 2  # the forward and backward epilogues
    # the fp32 K8's epilogue walk, its block size and its three products
    assert src.count(tool._TF_WALK) == 1 and src.count(tool._TF_PRODUCT) == 3
    assert src.count(tool._TF_JB) == 1

    def tf32_kernel(text):
        return text.split("film_fwd_tf32_kernel(")[1].split("\n}\n")[0]

    assert tf32_kernel(src).count("tc_regs_") == 2
    assert "tc_regs_" not in tf32_kernel(out["tf32_no_setmaxnreg"])
    assert "else if (r < -HALF_PI)" in out["branchy"].split(
        "trunk_sin(float v)")[0]
