"""The fp32 NeRF forward as 3xTF32 products (``nerf_mlp_fwd_tf32``,
csrc/nerf_mlp.cu's ``nerf_fwd_tf32_kernel``) on the CPU: its emulation
against the fp32 gate, its weight stream walked as the kernel walks it, and
the route ``NeRFModel.forward`` takes.

The CUDA kernel runs only on a card: ``python3 chip_smoke.py`` holds it
against ``nerf_mlp_fwd_tf32_plain`` there."""

import os
import re

import pytest
import torch

from msra_practice_project_tpu_torch.models.nerf import (NeRFConfig,
                                                         NeRFModel,
                                                         nerf_model)
from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K
from msra_practice_project_tpu_torch.ops.kernels.film_mlp import tf32_split

CSRC = os.path.join(os.path.dirname(K.__file__), "csrc")


@pytest.fixture(scope="module")
def field():
    """A PE model with the source's init and a density bias drawn from the
    view cell's range (1, 2), its packed fp32 weights, and 4,096 seeded
    points inside the render's bounds (positions in [-4, 4]^3, unit
    directions), padded."""
    gen = torch.Generator().manual_seed(3)
    m = nerf_model(False, generator=gen)
    with torch.no_grad():
        m.sigma.bias.uniform_(1.0, 2.0, generator=gen)
    pos = torch.rand((4096, 3), generator=gen) * 8.0 - 4.0
    dirs = torch.nn.functional.normalize(torch.randn((4096, 3), generator=gen),
                                         dim=-1)
    x = torch.cat([pos, dirs], dim=-1)
    packed = K.pack_nerf_params(m)
    w = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], False)
    return m, w, x, K.pad_points(x)


def _mm_1xtf32(a, b):
    return tf32_split(a)[0] @ tf32_split(b)[0]


def test_3xtf32_emulation_meets_the_fp32_gate_and_1xtf32_does_not(field):
    """The plain fp32 forward with every product of the trunk and the view
    branch emulated as the kernel computes it (3xTF32) stays within 1e-4 of
    max|ref| of the exact plain forward; one tf32 product per product is at
    least 10x further off."""
    _, w, _, x_pad = field
    ref = K.nerf_mlp_fwd_plain(x_pad, w, False)
    scale = float(ref.abs().max())
    errs = {}
    for name, mm in (("3x", K.mm_3xtf32), ("1x", _mm_1xtf32)):
        out = K._forward_plain(x_pad, w, False, mm)[0]
        errs[name] = float((out - ref).abs().max()) / scale
    assert errs["3x"] <= 1e-4, errs
    assert errs["1x"] >= 10 * errs["3x"], errs
    assert torch.equal(K.nerf_mlp_fwd_tf32(x_pad, w),
                       K.nerf_mlp_fwd_tf32_plain(x_pad, w))


def _walk_stack(x_pad, w):
    """The kernel's schedule over ``tf32_stack``: per product (N output
    columns, K-slices of 32 in stream order) acc (+)= per K-slice the big
    block's small(A) big(W) + big(A) big(W), then the small block's big(A)
    small(W); A holds the activations' K-major halves, e_pos before W0 and
    W5a, e_dir before W9b."""
    stack = K.tf32_stack(w)
    d = dict(zip(K.PACK_KEYS, w))
    pe_p, pe_d = K._pe(x_pad)
    row = 0

    def product(a, n, slices, acc=None):
        nonlocal row
        ab, as_ = tf32_split(a)
        for ks in range(slices):
            cols = slice(32 * ks, 32 * ks + 32)
            big, small = stack[row:row + n], stack[row + n:row + 2 * n]
            row += 2 * n
            part = (K.tf32_trunc(as_[:, cols]) @ big.t()
                    + ab[:, cols] @ big.t()
                    + ab[:, cols] @ K.tf32_trunc(small).t())
            acc = part if acc is None else acc + part
        return acc

    h = torch.relu(product(pe_p, 256, 2) + d["b0"])
    for i in range(1, 5):
        h = torch.relu(product(h, 256, 8) + d[f"b{i}"])
    h = torch.relu(product(pe_p, 256, 2, product(h, 256, 8)) + d["b5"])
    for i in (6, 7):
        h = torch.relu(product(h, 256, 8) + d[f"b{i}"])
    sig = torch.relu(h @ d["Ws"] + d["bs"])
    hd = product(h, 256, 8) + d["b8"]
    h9 = torch.relu(product(pe_d, 128, 1, product(hd, 128, 8)) + d["b9"])
    rgb = torch.sigmoid(h9 @ d["Wr"] + d["br"])
    assert row == stack.shape[0]
    return torch.cat([rgb[:, :3], sig[:, :1]], dim=1)


def test_tf32_stack_walked_as_the_kernel_walks_it_is_the_plain_version(field):
    """Each product's blocks lie in the stack where the kernel's producer
    reads them (``nt_slices``/``nt_cols`` order, 256 or 128 rows a block,
    big then small per K-slice); the walk gives the plain version's output
    up to fp32 summation order, and the stack's rows are the CUDA source's
    NT_STACK_ROWS."""
    _, w, _, x_pad = field
    got = _walk_stack(x_pad, w)
    want = K.nerf_mlp_fwd_tf32_plain(x_pad, w)[:, :4]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    with open(os.path.join(CSRC, "nerf_mlp.cu")) as f:
        src = f.read()
    m = re.search(r"static_assert\(NT_STACK_ROWS == (\d+),", src)
    assert m and int(m.group(1)) == K.tf32_stack(w).shape[0] == 37120
    # big + small is the weight, big is tf32 (low 13 bits zero)
    stack = K.tf32_stack(w)
    w0t = dict(zip(K.PACK_KEYS, w))["W0"].t()
    assert torch.equal(stack[:256] + stack[256:512], w0t[:, :32])
    assert not (stack[:256].view(torch.int32) & 0x1FFF).any()


class _CudaInput:
    """What the route reads of a CUDA float32 input of `rows` points."""
    is_cuda = True
    dtype = torch.float32

    def __init__(self, rows=4, requires_grad=False):
        self.rows, self.requires_grad = rows, requires_grad

    def numel(self):
        return 6 * self.rows


@pytest.mark.parametrize("case", ["kernel", "records_grad", "cpu", "siren",
                                  "widths", "empty"])
def test_route_takes_the_kernel_only_for_a_cuda_fp32_forward_without_graph(
        case):
    """The kernel's route: a CUDA float32 input that autograd does not record
    into the PE model at the kernel's widths; a grad-recording forward, a
    CPU input, the SirenNeRF, other widths and an empty input each take the
    plain forward."""
    cfg = {"siren": NeRFConfig(use_siren=True),
           "widths": NeRFConfig(pe_pos_length=6)}.get(case, NeRFConfig())
    m = NeRFModel(cfg)
    x = (torch.zeros(4, 6) if case == "cpu"
         else _CudaInput(rows=0 if case == "empty" else 4))
    if case != "records_grad":
        m.requires_grad_(False)
    assert K.takes_tf32_kernel(m, x) == (case == "kernel")
    with torch.no_grad():
        assert K.takes_tf32_kernel(m, x) == (case in ("kernel",
                                                      "records_grad"))


def test_cpu_forward_is_the_plain_forward_and_launches_nothing(field):
    m, _, x, _ = field
    K.reset_launch_counts()
    with torch.no_grad():
        assert torch.equal(m(x[:256]), m.forward_plain(x[:256]))
    assert K.nerf_mlp_fwd_tf32.launches == 0
