"""The split-K dW pass that K2, K5 and K7 share
(msra_practice_project_tpu_torch.ops.kernels.dw_splitk): its plain version
against per-task products and against the JAX package's dW on the CPU (the
Pallas kernel in interpret mode, as its own tests run it).

The CUDA kernel itself runs only on a card: ``python3 chip_smoke.py`` holds
it against this plain version there."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.ops.pallas import nerf_mlp as JK
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.ops.kernels import dw_splitk as DW
from msra_practice_project_tpu_torch.ops.kernels import film_mlp as FK
from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K
from msra_practice_project_tpu_torch.weights import state_dict_from_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = {"nerf": (K.grad_tasks, K.ACT_PAD, K.DELTA_W),
          "film": (FK.grad_tasks, FK.ACT_W, FK.DELTA_W)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test run has few cores to share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_operands(table, n, seed):
    tasks_fn, act_w, delta_w = TABLES[table]
    rng = np.random.default_rng(seed)
    acts = torch.from_numpy(rng.normal(size=(n, act_w)).astype(np.float32))
    deltas = torch.from_numpy(
        rng.normal(size=(n, delta_w)).astype(np.float32))
    return tasks_fn(), acts, deltas


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("table", ["nerf", "film"])
def test_plain_matches_per_task_products(table, splits):
    """Every task of both tables, 320 points: each split's partial is the
    fp32 product over its point range (ragged: 3 splits of 128, 128, 64
    points, 5 of 64; 16 splits of which 6 are empty and hold zeros), and dw
    their sum, to fp32 rounding (rtol 1e-5 of the largest entry)."""
    tasks, acts, deltas = _random_operands(table, 320, 0)
    partials, dw = DW.dw_splitk_plain(acts, deltas, tasks, splits)
    ranges = DW.split_ranges(320, splits)
    assert partials.shape == (splits, DW.task_total(tasks))
    assert ranges[-1][1] == 320 and all(lo <= hi for lo, hi in ranges)
    for a0, m, d0, n, off in tasks:
        for s, (lo, hi) in enumerate(ranges):
            d = deltas[lo:hi, d0:d0 + n].double()
            ref = (d.sum(0) if a0 < 0
                   else acts[lo:hi, a0:a0 + m].double().t() @ d)
            got = partials[s, off:off + m * n].view(ref.shape).double()
            scale = float(ref.abs().max()) if hi > lo else 1.0
            assert float((got - ref).abs().max()) <= 1e-5 * scale
        d = deltas[:, d0:d0 + n].double()
        ref = d.sum(0) if a0 < 0 else acts[:, a0:a0 + m].double().t() @ d
        got = dw[off:off + m * n].view(ref.shape).double()
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())


@pytest.mark.parametrize("n,splits", [(32, 1), (96, 16), (320, 3),
                                      (4096, 16), (65536, 16)])
def test_split_ranges_cut_the_points_in_whole_chunks(n, splits):
    """The splits (tile_mm.cuh's chunks_per_split) follow one another from
    0 to n, each but the last holding chunks_per_split chunks of PK points
    and the rest empty once the points run out."""
    ranges = DW.split_ranges(n, splits)
    per = DW.chunks_per_split(n, splits) * DW.PK
    assert len(ranges) == splits and ranges[0][0] == 0
    assert ranges[-1][1] == n
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2 and lo % DW.PK == 0
        assert hi - lo == per or hi == n
    assert sum(hi - lo for lo, hi in ranges) == n


def test_bias_tasks_share_their_deltas_with_a_weight_task():
    """tile_mm.cuh folds each bias task into the first weight task with the
    same delta columns (d0, N), whose first job must hold all N of them: at
    most 256 columns, or 128 when the weight's N is not a multiple of 64
    and M > N (the delta columns are then the 64-row operand)."""
    tasks = K.grad_tasks()
    weights = [t for t in tasks if t[0] >= 0]
    for a0, m, d0, n, off in tasks:
        if a0 >= 0:
            continue
        assert m == 1
        first = next(t for t in weights if (t[2], t[3]) == (d0, n))
        swap = first[3] % 64 != 0 and first[1] > first[3]
        assert n <= (128 if swap else 256)
    assert not [t for t in FK.grad_tasks() if t[0] < 0]


@pytest.mark.parametrize("table", ["nerf", "film"])
def test_plain_chunks_of_whole_splits_give_the_whole_partials(table):
    """K5 and K7 run the pass over chunks of whole splits: the partials of
    a chunk's splits, taken over the chunk alone, are bitwise the whole
    pass's rows for those splits, and dw sums them in split order."""
    tasks, acts, deltas = _random_operands(table, 512, 1)
    partials, dw = DW.dw_splitk_plain(acts, deltas, tasks, 4)
    per = DW.chunks_per_split(512, 4) * DW.PK
    for s0 in (0, 2):
        lo, hi = s0 * per, (s0 + 2) * per
        part, _ = DW.dw_splitk_plain(acts[lo:hi], deltas[lo:hi], tasks, 2)
        assert DW.chunks_per_split(hi - lo, 2) * DW.PK == per
        assert torch.equal(part, partials[s0:s0 + 2])
    total = partials[0] + partials[1]
    total = total + partials[2]
    assert torch.equal(dw, total + partials[3])


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_pass_matches_jax_dw(bf16):
    """The plain pass on the plain K1's activations and K2's delta
    workspace gives the JAX package's packed dW/db (fused_nerf_apply with
    interpret, need_dx=False, save_acts=True), 700 points in 3 ragged
    splits: fp32 to 1e-4 of each tensor's max, bf16 to 5e-2 relative
    Frobenius norm (relu masks flip on bf16-rounded activations)."""
    p = jnerf_model(False).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    p = jax.tree_util.tree_map(
        lambda a: (jnp.asarray(rng.uniform(-0.1, 0.1, a.shape), jnp.float32)
                   if a.ndim == 1 else a), p)
    m = nerf_model()
    m.load_state_dict(state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, p)))
    x = rng.normal(size=(700, 6)).astype(np.float32)
    dy = rng.normal(size=(700, 4)).astype(np.float32)

    def f(p):
        return JK.fused_nerf_apply(p, jnp.asarray(x), bf16, True, False, True)

    _, vjp = jax.vjp(f, p)
    ref = JK.pack_nerf_params(vjp(jnp.asarray(dy))[0])

    packed = K.pack_nerf_params(m)
    w = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], bf16)
    x_pad = K.pad_points(torch.from_numpy(x))
    dy_pad = F.pad(torch.from_numpy(dy),
                   (0, K.OUT_PAD - 4, 0, x_pad.shape[0] - 700))
    acts = K.nerf_mlp_fwd_save_plain(x_pad, w, bf16)[1]
    deltas = K.nerf_mlp_deltas_plain(w, dy_pad, acts, bf16)
    assert deltas.shape == (x_pad.shape[0], K.DELTA_W)
    _, dw = DW.dw_splitk_plain(acts, deltas, K.grad_tasks(), 3)
    for k in K.PACK_KEYS:
        a = np.asarray(ref[k])
        b = dw[K.GRAD_OFFS[k][0]:K.GRAD_OFFS[k][1]].view(
            K.PACK_SHAPES[k]).numpy()
        if bf16:
            rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
            assert rel <= 5e-2, (k, rel)
        else:
            scale = float(np.abs(a).max()) + 1e-8
            np.testing.assert_allclose(b / scale, a / scale, atol=1e-4,
                                       err_msg=k)


def test_deltas_plain_are_the_chain_k2_sums():
    """The delta workspace holds, column for column, the deltas whose
    products make the plain K2's gradients: the pass over it gives them."""
    rng = np.random.default_rng(2)
    m = nerf_model()
    packed = K.pack_nerf_params(m)
    w = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], False)
    x = K.pad_points(torch.from_numpy(
        rng.normal(size=(200, 6)).astype(np.float32)))
    dy = torch.from_numpy(rng.normal(size=(x.shape[0], K.OUT_PAD)).astype(
        np.float32))
    dy[:, 4:] = 0
    acts = K.nerf_mlp_fwd_save_plain(x, w, False)[1]
    grads = K.nerf_mlp_bwd_saved_plain(w, dy, acts, False)[0]
    deltas = K.nerf_mlp_deltas_plain(w, dy, acts, False)
    _, dw = DW.dw_splitk_plain(acts, deltas, K.grad_tasks(), 1)
    for k, g in zip(K.PACK_KEYS, grads):
        got = dw[K.GRAD_OFFS[k][0]:K.GRAD_OFFS[k][1]].view(g.shape)
        assert float((got - g).abs().max()) <= 1e-5 * max(
            float(g.abs().max()), 1e-30), k


@pytest.mark.parametrize("n", [128, 4096, 65536, 196608, 262144, 393216])
def test_k5_chunks_are_whole_splits(n):
    """K5's chunks (chunk_rows) hold whole splits of the pass over all n
    points and a multiple of ROW_MULT, so its partials are the whole
    pass's; K7's chunks of whole images hold whole chunks of PK points."""
    splits = K.bwd_splits(n)
    per = DW.chunks_per_split(n, splits) * DW.PK
    for bf16 in (False, True):
        rows = K.chunk_rows(n, bf16)
        assert rows == n or (rows % per == 0 and rows % K.ROW_MULT == 0)
    for n_img, n_pts in ((64, 8192), (64, 24576), (3, 64)):
        cb = FK.chunk_images(n_img, n_pts, True)
        assert 1 <= cb <= n_img and (cb * n_pts) % DW.PK == 0


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and counts no
    launch; the plain version refuses a point count off the chunk grid."""
    tasks, acts, deltas = _random_operands("film", 96, 3)
    before = DW.dw_splitk.launches
    got = DW.dw_splitk(acts, deltas, tasks, 2)
    ref = DW.dw_splitk_plain(acts, deltas, tasks, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert DW.dw_splitk.launches == before
    with pytest.raises(ValueError):
        DW.dw_splitk_plain(acts[:90], deltas[:90], tasks, 2)


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    tasks, acts, deltas = _random_operands("nerf", 64, 4)
    with pytest.raises(ValueError):
        DW.dw_splitk(acts.to("meta"), deltas.to("meta"), tasks, 1)


def test_probe_counts_the_bytes_the_jobs_load():
    """tools/torch_dw_probe.py's arithmetic: K2's jobs load 16,000 B per
    point of which 9,952 are needed once, K7's 14,848 of 9,264; without a
    second X half per weight no delta column is loaded twice."""
    spec = importlib.util.spec_from_file_location(
        "torch_dw_probe", os.path.join(ROOT, "tools", "torch_dw_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    v = probe.variants(K.grad_tasks())
    assert [len(v[k]) for k in ("full", "one_half", "weights")] == [26, 26, 14]
    assert probe.loaded_bytes_per_point(v["full"]) == 16000
    assert probe.needed_bytes_per_point(v["full"]) == 9952
    assert probe.loaded_bytes_per_point(FK.grad_tasks()) == 14848
    assert probe.needed_bytes_per_point(FK.grad_tasks()) == 9264
    assert DW.task_total(v["one_half"]) == sum(
        m * n for _, m, _, n, _ in v["one_half"])
    for a0, m, d0, n, _ in v["one_half"]:
        assert m <= 128

