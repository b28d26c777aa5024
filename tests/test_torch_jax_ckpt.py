"""Checkpoints the JAX package writes, read by the port
(msra_practice_project_tpu_torch.core.ckpt, core.msgpack_read, weights,
train.common), on the CPU.

For each of the four trainers the JAX package writes a train state with its
own ``core/ckpt.save`` (flax msgpack) after two Adam updates from random
gradients, and the trainer's config with its own ``save_config``.  The
port reads them with ``msgpack`` and ``flax`` blocked: forward outputs
equal the JAX ones at 1e-5, Adam's moments and counts carry over, and one
more update from identical gradients gives the JAX parameters at 1e-6
(optax adds eps outside the square root after bias correction, as
``torch.optim.Adam`` does).  The NeRF step from the loaded state matches
the JAX step at the train-step test's tolerances, and each port trainer
pointed at the JAX run directory resumes at its step."""

import os
import sys
import types

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch

from msra_practice_project_tpu.core import ckpt as jckpt
from msra_practice_project_tpu.core.config import (
    NERF_TRAIN_DEFAULTS as J_NERF, PIGAN_TRAIN_DEFAULTS as J_PIGAN,
    SIREN_IMG_DEFAULTS as J_IMG, SIREN_SDF_DEFAULTS as J_SDF,
    resolve as jresolve, save_config as jsave_config)
from msra_practice_project_tpu.models import pigan as jpigan
from msra_practice_project_tpu.models import siren_mlp as jsiren
from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.train import common as jcommon
from msra_practice_project_tpu.train.train_nerf import _make_step_impl
from msra_practice_project_tpu_torch import weights
from msra_practice_project_tpu_torch.core import ckpt, msgpack_read
from msra_practice_project_tpu_torch.core.config import (
    NERF_TRAIN_DEFAULTS, PIGAN_TRAIN_DEFAULTS, SIREN_IMG_DEFAULTS,
    SIREN_SDF_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.models import pigan, siren_mlp
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.train import (common, train_img,
                                                   train_nerf, train_pigan,
                                                   train_sdf)

KINDS = ("nerf", "pigan", "img", "sdf")
STEP = 2
PIGAN_GEN = dict(z_dim=32, resolution=8, coarse_samples=5, fine_samples=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)
                              * 1e-2), tree)


def _advance(params, tx, seed, n=STEP):
    """A JAX train state after ``n`` Adam updates from random gradients."""
    state = jcommon.init_state(params, tx)
    update = jax.jit(tx.update)
    for i in range(n):
        g = _random_like(params, seed + i)
        upd, opt = update(g, state["opt_state"], state["params"])
        state = {"params": jax.jit(optax.apply_updates)(state["params"],
                                                        upd),
                 "opt_state": opt, "step": state["step"] + 1}
    return state


def _init(factory, seed, *args):
    """Initial weights as a JAX tree, drawn by the port's initialiser from
    ``seed`` (the JAX package's eager init of the full-width pi-GAN models
    takes seconds)."""
    module = factory(*args, generator=torch.Generator().manual_seed(seed))
    return jax.tree_util.tree_map(
        jnp.asarray, weights.params_from_state_dict(module.state_dict()))


def _jax_run(kind, root):
    """A JAX run directory of trainer ``kind``: its resolved config and a
    step-2 checkpoint, both written by the JAX package.  Returns (config as
    a dict, the JAX state, the JAX models, the JAX optimizers)."""
    log = os.path.join(root, kind)
    base = dict(output_path=root, experiment_name=kind)
    if kind == "nerf":
        cfg = jresolve(dict(base, data_path="/nonexistent", batch_size=32,
                            start_up_itrs=0, render_coarse_sample_num=4,
                            render_fine_sample_num=4, data_size=8,
                            i_print=100, i_save=100, i_image=100), J_NERF)
        jm = jnerf_model(False)
        params = {"coarse": jm.init(jax.random.PRNGKey(0)),
                  "fine": jm.init(jax.random.PRNGKey(1))}
        tx = jcommon.adam(jcommon.exponential_lr(cfg["learning_rate"],
                                                 cfg["learning_rate_decay"]))
        state, models, txs = _advance(params, tx, 10), jm, tx
    elif kind == "pigan":
        cfg = jresolve(dict(base, data_path="/nonexistent", z_dim=32,
                            render_coarse_sample_num=5,
                            render_fine_sample_num=4, iterations=[STEP + 1],
                            fade_in_itrs=[0], batch_size=[2], resolution=[8],
                            i_print=100, i_save=100, i_image=100, data_n=4),
                       J_PIGAN)
        jg = jpigan.Generator(jpigan.GeneratorConfig(**PIGAN_GEN))
        jd = jpigan.Discriminator()
        g_tx = jcommon.adam(jcommon.interp_lr(
            cfg["generator_lr"], cfg["generator_lr_end"], cfg["lr_decay"]),
            betas=(0.0, 0.9))
        d_tx = jcommon.adam(jcommon.interp_lr(
            cfg["discriminator_lr"], cfg["discriminator_lr_end"],
            cfg["lr_decay"]), betas=(0.0, 0.9))
        g0 = _init(pigan.Generator, 0, pigan.GeneratorConfig(**PIGAN_GEN))
        d0 = _init(pigan.Discriminator, 1)
        state = {"g": _advance(g0, g_tx, 20), "d": _advance(d0, d_tx, 30),
                 "step": STEP}
        models, txs = (jg, jd), (g_tx, d_tx)
    else:
        factory = "img_model" if kind == "img" else "sdf_model"
        defaults = J_IMG if kind == "img" else J_SDF
        extra = (dict(data_size=16) if kind == "img" else
                 dict(data_path="", data_points=256, i_mesh=100, mesh_n=8,
                      final_mesh_n=8))
        cfg = jresolve(dict(base, batch_size=64, i_print=100, i_save=100,
                            i_image=100, **extra), defaults)
        jm = getattr(jsiren, factory)(cfg["model_type"])
        tx = jcommon.adam(cfg["learning_rate"])
        state = _advance(jm.init(jax.random.PRNGKey(3)), tx, 40)
        models, txs = jm, tx
    jsave_config(cfg, log)
    jckpt.save(log, STEP, state)
    return dict(cfg), state, models, txs


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_runs"))
    return root, {kind: _jax_run(kind, root) for kind in KINDS}


@pytest.fixture
def no_msgpack_or_flax(monkeypatch):
    """``import msgpack`` and ``import flax`` fail for the block."""
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("msgpack", "flax")]:
        monkeypatch.setitem(sys.modules, name, None)


def _port_models(kind, cfg):
    """The models and Adams the port's trainer builds for ``cfg``."""
    if kind == "nerf":
        models = {"coarse": nerf_model(False), "fine": nerf_model(False)}
        opt = common.adam([p for m in models.values() for p in
                           m.parameters()],
                          common.exponential_lr(cfg["learning_rate"],
                                                cfg["learning_rate_decay"]))
        return models, {"opt": (opt, models)}
    if kind == "pigan":
        g = pigan.Generator(pigan.GeneratorConfig(**PIGAN_GEN))
        d = pigan.Discriminator()
        g_opt = common.adam(g.parameters(), common.interp_lr(
            cfg["generator_lr"], cfg["generator_lr_end"], cfg["lr_decay"]),
            betas=(0.0, 0.9))
        d_opt = common.adam(d.parameters(), common.interp_lr(
            cfg["discriminator_lr"], cfg["discriminator_lr_end"],
            cfg["lr_decay"]), betas=(0.0, 0.9))
        return {"g": g, "d": d}, {"g_opt": (g_opt, {"g": g}),
                                  "d_opt": (d_opt, {"d": d})}
    factory = "img_model" if kind == "img" else "sdf_model"
    model = getattr(siren_mlp, factory)(cfg["model_type"])
    opt = common.adam(list(model.parameters()), cfg["learning_rate"])
    return {"model": model}, {"opt": (opt, {"model": model})}


def _load(kind, root, cfg):
    """Read the JAX checkpoint the way the port's trainers do."""
    saved = ckpt.restore(ckpt.ckpt_path(os.path.join(root, kind), STEP))
    assert weights.is_jax_train_state(saved)
    saved = weights.train_state_from_jax(saved, kind)
    models, opts = _port_models(kind, cfg)
    for name, m in models.items():
        m.load_state_dict(saved["models"][name] if "models" in saved
                          else saved[name])
    for key, (opt, named) in opts.items():
        common.load_adam(opt, saved[key], named)
    return saved, models, opts


def _jax_parts(kind, state):
    """{port model name: (JAX params, JAX Adam state)}."""
    if kind == "nerf":
        adam = state["opt_state"][0]
        return {k: (state["params"][k], types.SimpleNamespace(
            count=adam.count, mu=adam.mu[k], nu=adam.nu[k]))
            for k in ("coarse", "fine")}
    if kind == "pigan":
        return {k: (state[k]["params"], state[k]["opt_state"][0])
                for k in ("g", "d")}
    return {"model": (state["params"], state["opt_state"][0])}


def _forward_pairs(kind, jmodels, state, models, rng):
    """(port output, JAX output) pairs of each model on random inputs."""
    if kind == "nerf":
        x = (rng.normal(size=(7, 6)) * 0.5).astype(np.float32)
        for k in ("coarse", "fine"):
            with torch.no_grad():
                got = models[k](torch.from_numpy(x)).numpy()
            yield got, np.asarray(jmodels.apply(state["params"][k],
                                                jnp.asarray(x)))
    elif kind == "pigan":
        jg, jd = jmodels
        z = rng.normal(size=(2, PIGAN_GEN["z_dim"])).astype(np.float32)
        with torch.no_grad():
            film = models["g"].get_mapping(torch.from_numpy(z)).numpy()
        yield film, np.asarray(jg.get_mapping(state["g"]["params"],
                                              jnp.asarray(z)))
        img = rng.uniform(size=(2, 3, 8, 8)).astype(np.float32)
        with torch.no_grad():
            got = models["d"](torch.from_numpy(img), 8, 0.5).numpy()
        yield got, np.asarray(jd.apply(state["d"]["params"],
                                       jnp.asarray(img), 8, 0.5))
    else:
        x = rng.uniform(-1, 1, size=(9, 2 if kind == "img" else 3)).astype(
            np.float32)
        with torch.no_grad():
            got = models["model"](torch.from_numpy(x)).numpy()
        yield got, np.asarray(jmodels.apply(state["params"], jnp.asarray(x)))


@pytest.mark.parametrize("kind", KINDS)
def test_port_reads_jax_checkpoint_without_msgpack_or_flax(
        jax_runs, no_msgpack_or_flax, kind):
    """Forward outputs at 1e-5; Adam's first and second moments (linear
    weights transposed) and its count carried over."""
    root, runs = jax_runs
    cfg, state, jmodels, _ = runs[kind]
    with pytest.raises(ImportError):
        import msgpack  # noqa: F401
    with pytest.raises(ImportError):
        import flax  # noqa: F401
    saved, models, opts = _load(kind, root, cfg)
    assert saved["step"] == STEP
    for got, want in _forward_pairs(kind, jmodels, state, models,
                                    np.random.default_rng(0)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    parts = _jax_parts(kind, state)
    for key, (opt, named) in opts.items():
        assert opt.count == STEP
        for name, module in named.items():
            _, adam = parts[name]
            assert int(adam.count) == STEP
            for moment, field in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                want = weights.state_dict_from_params(
                    _np_tree(getattr(adam, field)))
                for n, p in module.named_parameters():
                    st = opt.opt.state[p]
                    assert float(st["step"]) == STEP
                    np.testing.assert_array_equal(st[moment].numpy(),
                                                  want[n].numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_loaded_adam_continues_the_jax_update(jax_runs, kind):
    """One more update from identical gradients: the port's Adam from the
    loaded moments and count gives the JAX parameters at 1e-6 (bias
    correction at count 3, eps outside the square root, the schedule at
    count 2)."""
    root, runs = jax_runs
    cfg, state, _, txs = runs[kind]
    _, models, opts = _load(kind, root, cfg)
    if kind == "pigan":
        pairs = [("g", state["g"], txs[0], opts["g_opt"]),
                 ("d", state["d"], txs[1], opts["d_opt"])]
    else:
        pairs = [(None, state, txs, opts["opt"])]
    for name, st, tx, (opt, named) in pairs:
        grads = _random_like(st["params"], 99)
        upd, _ = tx.update(grads, st["opt_state"], st["params"])
        want = _np_tree(optax.apply_updates(st["params"], upd))
        g_np = _np_tree(grads)
        for mname, module in named.items():
            sub = g_np if name is not None or kind != "nerf" \
                else g_np[mname]
            sd = weights.state_dict_from_params(sub)
            for n, p in module.named_parameters():
                p.grad = sd[n].clone()
        opt.step()
        for mname, module in named.items():
            w = want if name is not None or kind != "nerf" else want[mname]
            got = weights.params_from_state_dict(module.state_dict())
            for a, b in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(w)):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_nerf_step_from_jax_state_matches_jax_step(jax_runs):
    """The train step of test_torch_train_nerf.py from the loaded state:
    metrics at 1e-5, gradients at 5e-3 relative Frobenius norm (the fine
    pass's 2^9 PE frequency), and the updated parameters at 1e-6 when
    Adam is fed the JAX step's gradients."""
    root, runs = jax_runs
    cfg, state, jm, tx = runs["nerf"]
    cfg = dict(cfg, render_coarse_sample_num=9, render_fine_sample_num=17)
    rng = np.random.default_rng(0)
    ro = rng.normal(size=(32, 3)) * 0.1 + [0, 0, 4.0]
    rd = -ro / np.linalg.norm(ro, axis=-1, keepdims=True) \
        + 0.1 * rng.normal(size=(32, 3))
    batch = np.concatenate([ro, rd, rng.uniform(size=(32, 4))],
                           1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    new_state, m_j = _make_step_impl(jm, jm, tx, cfg)(
        state, jnp.asarray(batch), key)
    jitter = torch.from_numpy(np.array(
        jax.random.uniform(key, (32, 9), jnp.float32)))
    # gradients: optax's new mu = b1 mu + (1 - b1) g
    grads_j = jax.tree_util.tree_map(
        lambda new, old: (np.asarray(new) - 0.9 * np.asarray(old)) / 0.1,
        new_state["opt_state"][0].mu, state["opt_state"][0].mu)

    _, models, opts = _load("nerf", root, cfg)
    opt = opts["opt"][0]
    step = train_nerf.make_train_step(models["coarse"], models["fine"], opt,
                                      cfg, device="cpu")
    m_t = step(torch.from_numpy(batch), jitter=jitter)
    for k in ("loss", "loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    for name, model in models.items():
        got = jax.tree_util.tree_leaves(weights.params_from_state_dict(
            {k: p.grad for k, p in model.named_parameters()}))
        for a, b in zip(jax.tree_util.tree_leaves(grads_j[name]), got):
            rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
            assert rel < 5e-3, (name, rel)

    _, models, opts = _load("nerf", root, cfg)
    for name, model in models.items():
        sd = weights.state_dict_from_params(grads_j[name])
        for n, p in model.named_parameters():
            p.grad = sd[n].clone()
    opts["opt"][0].step()
    for name, model in models.items():
        want = jax.tree_util.tree_leaves(_np_tree(new_state["params"][name]))
        got = jax.tree_util.tree_leaves(
            weights.params_from_state_dict(model.state_dict()))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-6)


TRAINERS = {"nerf": (train_nerf, NERF_TRAIN_DEFAULTS),
            "pigan": (train_pigan, PIGAN_TRAIN_DEFAULTS),
            "img": (train_img, SIREN_IMG_DEFAULTS),
            "sdf": (train_sdf, SIREN_SDF_DEFAULTS)}


@pytest.mark.parametrize("kind", KINDS)
def test_port_trainer_resumes_a_jax_run(jax_runs, tmp_path, kind, capsys):
    """The port's trainer, pointed at a copy of the JAX run directory,
    resumes at the JAX step with the JAX weights and runs on from there."""
    import shutil
    root, runs = jax_runs
    cfg, _, _, _ = runs[kind]
    shutil.copytree(os.path.join(root, kind), str(tmp_path / kind))
    mod, defaults = TRAINERS[kind]
    cfg = resolve(dict(cfg, output_path=str(tmp_path)), defaults)
    if kind == "pigan":
        out = mod.train(cfg, device="cpu")
        assert out["g_opt"].count == out["d_opt"].count == STEP + 1
        assert f"Resumed at step {STEP}" in capsys.readouterr().out
    else:
        cfg["iterations"] = STEP + 1
        out = mod.train(cfg, device="cpu")
        assert out["state"]["step"] == STEP + 1
        assert out["state"]["opt"].count == STEP + 1
        assert "Reloading from" in capsys.readouterr().out
        assert len(out["log"]["loss"]) == 1   # the JAX run left no log


def test_eval_loaders_read_jax_runs(jax_runs):
    """eval.nerf_common.load_experiment and eval.pigan_demo.load_generator
    on the JAX run directories hold the JAX weights."""
    from msra_practice_project_tpu_torch.eval.nerf_common import (
        load_experiment)
    from msra_practice_project_tpu_torch.eval.pigan_demo import (
        load_generator)
    root, runs = jax_runs
    _, state, _, _ = runs["nerf"]
    cfg, models, saved, step = load_experiment(os.path.join(root, "nerf"),
                                               device="cpu")
    assert step == STEP and saved["step"] == STEP
    for name, model in zip(("coarse", "fine"), models):
        want = jax.tree_util.tree_leaves(_np_tree(state["params"][name]))
        got = jax.tree_util.tree_leaves(
            weights.params_from_state_dict(model.state_dict()))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    cfg, state, _, _ = runs["pigan"]
    g, d, step = load_generator(resolve(cfg, PIGAN_TRAIN_DEFAULTS),
                                device="cpu")
    assert step == STEP
    for module, name in ((g, "g"), (d, "d")):
        want = jax.tree_util.tree_leaves(_np_tree(state[name]["params"]))
        got = jax.tree_util.tree_leaves(
            weights.params_from_state_dict(module.state_dict()))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_torn_checkpoint_is_skipped_and_unknown_format_raises(jax_runs,
                                                              tmp_path):
    """A truncated newest snapshot (of either format) falls back to the
    previous one; a file of neither format raises instead of letting a run
    start afresh."""
    import shutil
    root, _ = jax_runs
    log = str(tmp_path / "run")
    shutil.copytree(os.path.join(root, "img"), log)
    with open(ckpt.ckpt_path(log, STEP), "rb") as f:
        data = f.read()
    with open(ckpt.ckpt_path(log, STEP + 1), "wb") as f:
        f.write(data[:len(data) // 2])
    ckpt.save(log, STEP + 2, {"step": 4})
    with open(ckpt.ckpt_path(log, STEP + 2), "r+b") as f:
        f.truncate(100)
    step, tree = ckpt.restore_latest(log)
    assert step == STEP and weights.is_jax_train_state(tree)
    with open(ckpt.ckpt_path(log, STEP + 3), "wb") as f:
        f.write(b"\x00\x01not a checkpoint")
    with pytest.raises(ckpt.UnknownFormat):
        ckpt.restore_latest(log)
    with pytest.raises(ckpt.UnknownFormat):
        common.resume(log, common.init_state(
            {"model": torch.nn.Linear(2, 2)},
            common.adam(torch.nn.Linear(2, 2).parameters(), 1e-3)), "img")


@pytest.mark.parametrize("payload", ["uint32", "ext5"])
def test_undecodable_checkpoint_raises_rather_than_restarting(tmp_path,
                                                              payload):
    """A whole msgpack snapshot holding a value the reader does not decode
    (a uint32 array, which flax writes as its ext type 1, or another ext
    type) is not a torn file: restore_latest and a trainer's resume raise
    UnknownFormat instead of skipping it and starting afresh."""
    from flax import serialization
    if payload == "uint32":
        data = serialization.to_bytes(
            {"step": 3, "params": {"w": np.arange(4, dtype=np.uint32)}})
    else:
        data = msgpack.packb({"step": 3, "x": msgpack.ExtType(5, b"abc")},
                             use_bin_type=True)
    log = str(tmp_path / "run")
    os.makedirs(log)
    with open(ckpt.ckpt_path(log, 3), "wb") as f:
        f.write(data)
    with pytest.raises(ckpt.UnknownFormat, match="not"):
        ckpt.restore_latest(log)
    with pytest.raises(ckpt.UnknownFormat):
        common.resume(log, common.init_state(
            {"model": torch.nn.Linear(2, 2)},
            common.adam(torch.nn.Linear(2, 2).parameters(), 1e-3)), "img")


def test_msgpack_reader_matches_msgpack():
    """Every type flax's checkpoints use, at each of its encodings, read as
    the msgpack package reads it; flax's array ext types (bfloat16, int32,
    bool, 0-d and numpy scalars) as flax reads them."""
    from flax import serialization
    values = [0, 127, 128, 255, 256, 65536, 2**32, -1, -32, -33, -129,
              -40000, -2**40, 1.5, True, False, None, "", "a" * 31,
              "b" * 32, "c" * 300, "d" * 70000, b"\x00\x01", b"e" * 300,
              list(range(3)), list(range(20)), list(range(70000))]
    tree = {str(i): v for i, v in enumerate(values)}
    tree["big"] = {str(i): i for i in range(20)}
    tree["f32"] = np.float32(0.25).item()
    data = msgpack.packb(tree, use_bin_type=True)
    assert msgpack_read.loads(data) == msgpack.unpackb(data, raw=False)
    assert msgpack_read.loads(msgpack.packb(2.5, use_single_float=True)) \
        == 2.5
    arrays = {"bf16": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3,
              "i32": np.arange(5, dtype=np.int32) - 2,
              "bool": np.array([True, False]),
              "f64": np.linspace(0, 1, 4),
              "zero_d": np.asarray(np.float32(3.5)),
              "scalar": np.int32(7),
              "nested": (np.ones((2, 2), np.float32), {"x": None})}
    data = serialization.to_bytes(arrays)
    got = msgpack_read.loads(data)
    want = serialization.msgpack_restore(data)
    assert got["scalar"] == 7 and got["nested"]["1"] == {"x": None}
    for k in ("bf16", "i32", "bool", "f64", "zero_d"):
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    assert got["bf16"].dtype == torch.bfloat16
    assert got["zero_d"].shape == ()
    np.testing.assert_array_equal(got["nested"]["0"].numpy(), np.ones((2, 2)))
    with pytest.raises(ValueError, match="truncated"):
        msgpack_read.loads(data[:-3])
