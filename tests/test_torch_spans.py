"""The port's spans (``core/diagnostics.span``, ``span_steps``,
``reset_spans``) inside the NeRF train step, the render library and the
pi-GAN steps, on the CPU: off without a profiler, the same results with one,
the trees they record, their nesting across threads and the store's bound."""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msra_practice_project_tpu_torch.core import diagnostics as D
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.ops.kernels.nerf_mlp import \
    fused_nerf_apply
from msra_practice_project_tpu_torch.train import common, train_nerf, \
    train_pigan

NERF_CFG = {"use_fine_model": True, "use_alpha": True, "render_near": 2.0,
            "render_far": 6.0, "render_coarse_sample_num": 4,
            "render_fine_sample_num": 4}
GEN_CFG = dict(z_dim=16, resolution=8, coarse_samples=3, fine_samples=4)
RENDER = ["render.samples", "render.mlp", "render.composite",
          "render.resample"]


@pytest.fixture(autouse=True)
def _fresh_store():
    """One intra-op thread (these steps are small), and an empty store."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    D.reset_spans()
    yield
    D.reset_spans()
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _nerf():
    """(step, its models, its inputs): a NeRF train step at 32 rays."""
    gen = torch.Generator().manual_seed(0)
    models = [nerf_model(False, generator=gen) for _ in range(2)]
    opt = common.adam([p for m in models for p in m.parameters()], 5e-4)
    step = train_nerf.make_train_step(*models, opt, NERF_CFG, "cpu")
    batch = torch.cat([torch.randn(32, 3, generator=gen) * 0.1 + 4.0,
                       torch.randn(32, 3, generator=gen),
                       torch.rand(32, 4, generator=gen)], dim=1)
    jitter = torch.rand(32, 4, generator=gen)
    return step, models, (batch, jitter)


def _gan():
    """(d_step, g_step, their models, their inputs) at a batch of 2 at
    8x8."""
    gen = torch.Generator().manual_seed(1)
    g = pigan.Generator(pigan.GeneratorConfig(**GEN_CFG), generator=gen)
    d = pigan.Discriminator(generator=gen)
    d_step, g_step = train_pigan.make_gan_steps(
        g, d, common.adam(g.parameters(), 1e-4, (0.0, 0.9)),
        common.adam(d.parameters(), 4e-4, (0.0, 0.9)), 8)
    draws = {"poses": (torch.randn(2, generator=gen),
                       torch.randn(2, generator=gen)),
             "jitter": torch.rand(2, 64, 3, generator=gen)}
    return d_step, g_step, (g, d), (torch.rand(2, 3, 8, 8, generator=gen),
                                     torch.randn(2, 16, generator=gen),
                                     draws)


def _run_nerf(step, inputs, n=1):
    batch, jitter = inputs
    return [step(batch, jitter=jitter)["loss"] for _ in range(n)]


def _run_gan(d_step, g_step, inputs, n=1):
    real, z, draws = inputs
    out = []
    for _ in range(n):
        out.append(d_step(real, z, 0.5, **draws)["d_loss"])
        out.append(g_step(z, 0.5, **draws)["g_loss"])
    return out


def _params(models):
    return [p.detach().clone() for m in models for p in m.parameters()]


def test_off_without_a_profiler_and_the_same_results_with_one():
    """No profiler: ``span`` returns one shared no-op object and nothing is
    recorded.  A NeRF step and a D + G step from the same state give
    bitwise the same losses and weights with a profiler on and off."""
    assert D.span("a") is D.span("b") is D._NO_SPAN
    with D.span("a"):
        with D.span("b"):
            pass
    assert D.span_steps("a", 10) is None and not D._roots

    step, models, inputs = _nerf()
    d_step, g_step, gan_models, gan_inputs = _gan()
    off = (_run_nerf(step, inputs, 2) + _run_gan(d_step, g_step, gan_inputs),
           _params(models + list(gan_models)))
    assert not D._roots
    step, models, inputs = _nerf()      # the same seeded state again
    d_step, g_step, gan_models, gan_inputs = _gan()
    with _cpu_profile():
        on = (_run_nerf(step, inputs, 2)
              + _run_gan(d_step, g_step, gan_inputs),
              _params(models + list(gan_models)))
    assert D.span_steps("nerf.step", 2) is not None
    for a, b in zip(off[0] + off[1], on[0] + on[1]):
        assert torch.equal(a, b)


def test_nerf_step_tree_counts_and_chrome_trace(tmp_path):
    """Two NeRF steps under a CPU profiler: the ``nerf.step`` tree with its
    four children, the render library's stages under ``nerf.render`` with
    two MLP calls and two composites a step, on the CPU device time equal
    to host time; the Chrome trace nests the spans in order."""
    step, _, inputs = _nerf()
    with _cpu_profile() as prof:
        _run_nerf(step, inputs, 2)
    per = D.span_steps("nerf.step", 10)
    parents = {k: v["parent"] for k, v in per.items()}
    assert parents == {"nerf.step": None, "nerf.render": "nerf.step",
                       "nerf.loss": "nerf.step", "nerf.backward": "nerf.step",
                       "adam": "nerf.step", "render.samples": "nerf.render",
                       "render.mlp": "nerf.render",
                       "render.composite": "nerf.render",
                       "render.resample": "nerf.render"}
    counts = {k: v["count"] for k, v in per.items()}
    assert counts == {k: (2.0 if k in ("render.mlp", "render.composite")
                          else 1.0) for k in per}
    for v in per.values():
        assert v["host_ms"] > 0 and v["device_ms"] == v["host_ms"]
    root = per["nerf.step"]["host_ms"]
    assert sum(per[k]["host_ms"] for k in ("nerf.render", "nerf.loss",
                                           "nerf.backward", "adam")) <= root
    assert D.span_steps("nerf.step", 1)["nerf.step"]["count"] == 1.0

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e]

    def spans_of(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e["name"] == name)

    steps = spans_of("nerf.step")
    assert len(steps) == 2
    for s0, s1 in steps:
        inner = [(n, a) for n in ("nerf.render", "nerf.loss",
                                  "nerf.backward", "adam")
                 for a, b in spans_of(n) if s0 <= a and b <= s1]
        assert [n for n, _ in sorted(inner, key=lambda x: x[1])] == [
            "nerf.render", "nerf.loss", "nerf.backward", "adam"]
    (r0, r1), = spans_of("nerf.render")[:1]
    assert [n for a, n in sorted((a, n) for n in RENDER
                                 for a, b in spans_of(n)
                                 if r0 <= a and b <= r1)] == [
        "render.samples", "render.mlp", "render.composite",
        "render.resample", "render.mlp", "render.composite"]


def test_gan_steps_trees():
    """A D step and a G step: each root with its children in order, and
    one Adam each; R1 sits under the D step, beside D's backward."""
    d_step, g_step, _, inputs = _gan()
    with _cpu_profile():
        _run_gan(d_step, g_step, inputs, 2)
    d = D.span_steps("gan.d_step", 5)
    g = D.span_steps("gan.g_step", 5)
    children = [k for k, v in d.items() if v["parent"] == "gan.d_step"]
    assert children == ["gan.fakes", "gan.d_forward", "gan.r1",
                        "gan.d_backward", "adam"]
    assert [k for k, v in g.items() if v["parent"] == "gan.g_step"] == [
        "gan.g_forward", "gan.g_d_forward", "gan.g_backward", "adam"]
    for per in (d, g):
        assert all(per[k]["count"] == 1.0 for k in per
                   if per[k]["parent"] in (None, "gan.d_step", "gan.g_step"))
    # G renders through the render library in both steps
    assert d["render.mlp"]["parent"] == "gan.fakes"
    assert g["render.mlp"]["parent"] == "gan.g_forward"


def test_fused_nerf_apply_spans():
    """One ``fused_nerf_apply`` call (the kernels' plain versions on the
    CPU) and its backward: the weights once, K1's and K2's wrappers once
    each."""
    model = nerf_model(False, generator=torch.Generator().manual_seed(2))
    x = torch.randn(16, 6)
    with _cpu_profile():
        with D.span("t"):
            out = fused_nerf_apply(model, x, True, need_dx=False,
                                   save_acts=True)
            out.sum().backward()
    per = D.span_steps("t", 1)
    assert {k: (v["parent"], v["count"]) for k, v in per.items()} == {
        "t": (None, 1.0), "nerf_mlp.weights": ("t", 1.0),
        "nerf_mlp.fwd_call": ("t", 1.0), "nerf_mlp.bwd_call": ("t", 1.0)}
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())


def test_a_span_opened_in_another_thread_nests_under_the_open_one():
    """As autograd's device thread does during ``backward()``."""
    with _cpu_profile():
        with D.span("outer"):
            t = threading.Thread(target=lambda: D.span("inner").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    per = D.span_steps("outer", 1)
    assert per["inner"]["parent"] == "outer" and per["inner"]["count"] == 1
    assert D.span_steps("inner", 1) is None


def test_span_steps_reads_the_first_roots_and_the_store_stops(monkeypatch):
    """None on an empty store; the mean over the first n roots only; no
    root kept past the bound, nor its children; a reset empties it."""
    assert D.span_steps("r", 1) is None
    clock = [0]
    monkeypatch.setattr(D.time, "perf_counter_ns", lambda: clock[0])
    monkeypatch.setattr(D, "SPAN_ROOTS", 3)
    with _cpu_profile():
        for ms in (1, 2, 3, 4):
            with D.span("r"):
                with D.span("c"):
                    clock[0] += ms * 1_000_000
                clock[0] += 1_000_000
    assert len(D._roots) == 3
    assert D.span_steps("r", 2)["c"]["host_ms"] == pytest.approx(1.5)
    assert D.span_steps("r", 2)["r"]["host_ms"] == pytest.approx(2.5)
    assert D.span_steps("r", 10)["c"]["device_ms"] == pytest.approx(2.0)
    D.reset_spans()
    assert D.span_steps("r", 10) is None


def test_step_profiler_prints_its_window_spans(tmp_path, capsys):
    """``StepProfiler`` empties the store as its window opens and prints a
    table of the spans per root when it closes."""
    with _cpu_profile():
        with D.span("stale"):
            pass
    prof = D.StepProfiler(str(tmp_path), 2, skip=1)
    for step in range(1, 5):
        prof.tick(step)
        with D.span("work"):
            with D.span("part"):
                torch.ones(4).add_(1)
    prof.stop()
    out = capsys.readouterr().out
    assert "spans per work (2)" in out and "part" in out
    assert "stale" not in out


def test_cuda_events_come_from_a_pool_and_capture_is_inert(monkeypatch):
    """The CUDA path with stand-ins for the stream and events: each span
    records its two events on the current stream and reads their elapsed
    time; a reset returns them to the pool and the next spans reuse them;
    a span opened while a CUDA graph is captured is inert."""
    clock, made = [0.0], []

    class Event:
        def __init__(self, enable_timing):
            made.append(self)

        def record(self, stream):
            assert stream == "stream0"
            self.at = clock[0]

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.at - self.at

    class Stream(str):
        device_index = 0

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(D, "_current_stream", lambda: Stream("stream0"))
    with _cpu_profile():
        for window in range(2):
            for ms in (1.0, 3.0):
                with D.span("r"):
                    clock[0] += ms
                    with D.span("c"):
                        clock[0] += 2 * ms
            per = D.span_steps("r", 2)
            assert per["r"]["device_ms"] == pytest.approx(6.0)
            assert per["c"]["device_ms"] == pytest.approx(4.0)
            assert len(made) == 8           # the second window reuses them
            D.reset_spans()
        capturing[0] = True
        assert D.span("r") is D._NO_SPAN
