"""The program's tracer (``pixie_tpu_torch/utils/observability.py``) and
its spans in the solver's frames and the material stage, on the CPU.

Off (no ``tracing()`` open), ``span`` is one shared no-op that reads no
clock and opens no profiler range.  On, it records ``[name, parent,
start_ns, end_ns]`` on ``time.time_ns()``'s clock, the clock of a
profiler's host events, and opens ``pixie.<name>`` in a profiler trace.
The frames run bitwise alike with the tracer on and off.  The ``cuda``
case holds a kernel's launch, as the card's profiler records it, inside
the span that launched it:

    python -m pytest tests/test_torch_tracing.py -m cuda
"""

import gc
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity import cuda_device  # noqa: F401  (fixture)

from pixie_tpu_torch.ops import fused_substep as fs
from pixie_tpu_torch.ops import transfer
from pixie_tpu_torch.sim import bc as tbc
from pixie_tpu_torch.sim import solver as tsolver
from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state
from pixie_tpu_torch.utils import observability as obs

N, DT, SUBSTEPS = 300, 1e-4, 12
FIELDS = ("x", "v", "C", "F", "F_trial", "stress", "mu", "lam", "yield_stress", "cov")
# a profiler's host event opens just before the span's first stamp and closes
# just after its last (6-22 us apart on a CPU host, torch 2.13)
CLOCK_NS = 50_000


def _pixie_events(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("pixie.")]


# -- the tracer ----------------------------------------------------------------------------

def test_span_off_is_a_shared_noop_without_clock_or_range(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the tracer is off")

    assert not obs.enabled()
    monkeypatch.setattr(obs.time, "time_ns", boom)
    monkeypatch.setattr(obs.torch.profiler, "record_function", boom)
    assert obs.span("a") is obs.span("b")
    with obs.span("a"):
        obs.count("n", 1)
        obs.count("d", torch.tensor(3))
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("sim.frame"):
            torch.ones(8).sum()
    assert not _pixie_events(prof)


@pytest.mark.parametrize("case", ["nested", "counters", "gc"])
def test_tracing_records_spans_counters_and_collections(case):
    with obs.tracing() as t:
        assert obs.enabled() and t.use_profiler
        with obs.span("frame"):
            if case == "nested":
                for _ in range(2):
                    with obs.span("stage"):
                        with obs.span("inner"):
                            time.sleep(1e-3)
                time.sleep(2e-3)
            elif case == "counters":
                for v in (2, 3):
                    obs.count("host", v)
                    obs.count("device", torch.tensor(v, dtype=torch.int64))
                assert t.counters == {"host": 5}      # tensors are read once, on closing
            else:
                gc.collect()
    assert not obs.enabled() and obs.span("x") is obs.span("y")
    assert all(r[2] <= r[3] for r in t.records)
    names = [r[0] for r in t.records]
    s = t.summary()
    if case == "nested":
        assert names == ["frame", "stage", "inner", "stage", "inner"]
        assert [r[1] for r in t.records] == [-1, 0, 1, 0, 3]
        assert {k: v["calls"] for k, v in s.items()} == {"frame": 1, "stage": 2, "inner": 2}
        for outer, inner in (("frame", "stage"), ("stage", "inner")):
            assert s[outer]["self_s"] == pytest.approx(
                s[outer]["total_s"] - s[inner]["total_s"], abs=1e-9)
        assert s["inner"]["self_s"] == s["inner"]["total_s"] >= 2e-3
        assert s["frame"]["self_s"] >= 2e-3
        assert t.time_profile["inner"] == [pytest.approx(v, abs=1e-9) for v in
                                           [(r[3] - r[2]) * 1e-9 for r in t.records[2::2]]]
    elif case == "counters":
        assert t.counters == {"host": 5, "device": 5}
    else:
        gcs = [r for r in t.records if r[0] == "python.gc"]
        assert gcs and all(r[1] == 0 for r in gcs)
        assert s["frame"]["self_s"] < s["frame"]["total_s"]
    # the callback is gone with the tracer
    assert all(getattr(cb, "__self__", None) is not t for cb in gc.callbacks)


def test_tracing_does_not_nest():
    with obs.tracing():
        with pytest.raises(RuntimeError, match="already open"):
            with obs.tracing():
                pass
    assert not obs.enabled()


def test_span_stamps_share_the_profilers_clock():
    with obs.tracing() as t, profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(30):
            with obs.span(f"clock.{i}"):
                torch.ones(64).sum()
    events = {e.name(): e for e in _pixie_events(prof)}
    starts, ends = [], []
    for name, _, s, e in t.records[5:]:              # the first ranges warm the profiler up
        if name == "python.gc":                      # a collection opens no profiler range
            continue
        ev = events[f"pixie.{name}"]
        assert ev.start_ns() - CLOCK_NS <= s <= e <= ev.end_ns() + CLOCK_NS, name
        starts.append(s - ev.start_ns())
        ends.append(ev.end_ns() - e)
    assert abs(statistics.median(starts)) < CLOCK_NS and abs(statistics.median(ends)) < CLOCK_NS


# -- the solver's frames -------------------------------------------------------------------

def _state(seed=3):
    rng = np.random.default_rng(seed)
    mats = np.asarray((0, 2, 3, 5), np.int32)[np.arange(N) % 4]
    st = finalize_mu_lam(make_state(rng.uniform(0.7, 1.3, (N, 3)).astype(np.float32),
                                    np.full(N, 1e-6, np.float32), density=300.0, E=2e5, nu=0.3,
                                    material=mats,
                                    yield_stress=rng.uniform(50.0, 400.0, N).astype(np.float32)))
    return st.replace(v=torch.as_tensor((0.5 * rng.normal(size=(N, 3))).astype(np.float32)),
                      selection=torch.as_tensor((np.arange(N) % 17 == 4).astype(np.int32)))


def _solver(fused: bool):
    s = tsolver.MPMSolver(n_grid=16, grid_lim=2.0, device="cpu", fused=fused)
    s.cfg = MPMConfig(n_grid=16, grid_lim=2.0, gravity=(0.0, 0.0, -9.8), rpic_damping=0.1,
                      active_materials=(0, 2, 3, 5), hardening=1.0, xi=0.1,
                      plastic_viscosity=0.05, softening=0.5, friction_angle=30.0)
    s.state = _state()
    s.bcs = [tbc.make_surface_collider((1.0, 1.0, 0.75), (0.0, 0.0, 1.0), "sticky")]
    return s


def _with_cell_order(monkeypatch):
    """P2G and the fused frame's re-sort return random orders, as the card
    returns cell orders, and the frames re-sort every 5 substeps."""
    real_p2g, rng = transfer.p2g, np.random.default_rng(5)

    def p2g(*a, return_order=False, **k):
        grid = real_p2g(*a, **k)
        return (grid, torch.as_tensor(rng.permutation(N))) if return_order else grid

    monkeypatch.setattr(transfer, "p2g", p2g)
    monkeypatch.setattr(transfer, "cell_order", lambda x, active, cfg: torch.as_tensor(
        rng.permutation(N)))
    monkeypatch.setattr(tsolver, "RESORT_EVERY", 5)


@pytest.mark.parametrize("ordered", [False, True], ids=["caller_order", "cell_order"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_frame_spans_and_state_bitwise_with_tracer_on(fused, ordered, monkeypatch):
    states = []
    for on in (False, True):
        if ordered:
            _with_cell_order(monkeypatch)
        s = _solver(fused)
        if on:
            with obs.tracing() as t:
                assert s.step_frame(SUBSTEPS, DT) is fused
        else:
            assert s.step_frame(SUBSTEPS, DT) is fused
        states.append(s.state)
        monkeypatch.undo()
    for k in FIELDS:
        assert torch.equal(getattr(states[0], k), getattr(states[1], k)), k

    calls = {k: v["calls"] for k, v in t.summary().items()}
    resorts = 3 if ordered else 0           # substeps 0, 5 and 10 (fused: the prologue's sort)
    if fused:
        sampled = len(range(0, SUBSTEPS - 1, tsolver.RUN_LENGTH_EVERY))
        want = {"sim.frame": 1, "sim.constitutive": 1, "sim.p2g": 1, "sim.grid": SUBSTEPS,
                "sim.fused": SUBSTEPS - 1, "sim.run_length": sampled, "sim.g2p": 1}
        live = N - len(range(4, N, 17))     # every particle in the grid, all but the inactive
        assert t.counters["fused.live_lanes"] == sampled * live
        assert sampled <= t.counters["fused.runs"] <= t.counters["fused.live_lanes"]
    else:
        want = {"sim.frame": 1, **{k: SUBSTEPS for k in ("sim.particle_bc", "sim.constitutive",
                                                         "sim.p2g", "sim.grid", "sim.g2p")}}
        assert t.counters == {}
    if resorts:
        want["sim.resort"] = resorts
    assert {k: v for k, v in calls.items() if k != "python.gc"} == want
    # every stage is a child of the frame
    assert all(r[1] == 0 for r in t.records[1:] if r[0] != "python.gc")


def _runs_by_walking(x, active, cfg, warp):
    """Live lanes and runs by the definition, lane by lane."""
    live = runs = 0
    prev = None                         # the base cell of the lane before, if live
    for i in range(x.shape[0]):
        base = np.floor(x[i].numpy().astype(np.float64) * cfg.inv_dx - 0.5)
        ok = bool(active[i]) and bool(np.all((base >= -2) & (base <= cfg.n_grid - 1)))
        cell = tuple(base) if ok else None
        if ok:
            live += 1
            runs += i % warp == 0 or cell != prev
        prev = cell
    return live, runs


@pytest.mark.parametrize("warp", [8, 32])
def test_run_counts_walk_the_lanes(warp):
    st, cfg = _state(), _solver(False).cfg
    active = st.selection == 0
    x = st.x.clone()
    x[7, 1], x[40, 0], x[41, 2] = float("nan"), float("inf"), 5.0        # not live
    order = transfer.cell_order(x, active, cfg)
    for xs, a in ((x, active), (x[order], active[order])):
        live, runs = fs.run_counts(xs, a, cfg, warp)
        assert live.dtype == runs.dtype == torch.int64 and live.dim() == runs.dim() == 0
        assert (int(live), int(runs)) == _runs_by_walking(xs, a, cfg, warp)
        assert fs.mean_run_length(xs, a, cfg, warp) == int(live) / int(runs)


# -- the material stage --------------------------------------------------------------------

def test_material_stage_spans_per_object():
    from pixie_tpu_torch.models.unet3d import RegressionUNet, SegmentationUNet, seeded_state_dict
    from pixie_tpu_torch.train.inference import CombinedInference
    from pixie_tpu_torch.utils.norm import REFERENCE_RANGES, unscale_prediction

    kw = dict(feature_channels=16, cond_dim=16, model_channels=8, num_res_blocks=1,
              channel_mult=(1, 2), grid_size=8)
    nets = [SegmentationUNet(num_classes=8, **kw), RegressionUNet(out_channels=3, **kw)]
    sds = [seeded_state_dict(m, 20 + i) for i, m in enumerate(nets)]
    infer = CombinedInference(*sds, grid_size=8, feature_channels=16, device="cpu",
                              model_kwargs={k: kw[k] for k in ("cond_dim", "model_channels",
                                                               "num_res_blocks", "channel_mult")})
    grids = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 8, 8, 8, 16)),
                            dtype=torch.float16)
    def objects():
        return [unscale_prediction(infer.combined_prediction(*infer.predict_device(g)),
                                   REFERENCE_RANGES) for g in grids]

    off = objects()
    with obs.tracing() as t:
        on = objects()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    calls = {k: v["calls"] for k, v in t.summary().items() if k != "python.gc"}
    assert calls == {"unet.forward": 2, "material.post": 2, "material.unscale": 2}
    assert [r[1] for r in t.records if r[0] != "python.gc"] == [-1] * 6


# -- on the card ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("launch", ["aten", "port_kernel"])
def test_kernel_launch_lies_in_its_span_on_the_card(launch, cuda_device):
    """Each kernel's launch (the runtime event of the same correlation id)
    lies inside the span that launched it, on the tracer's clock."""
    x = torch.rand((4096, 3), device=cuda_device) + 0.5
    active = torch.ones(4096, dtype=torch.bool, device=cuda_device)
    cfg = MPMConfig(n_grid=16, grid_lim=2.0)

    def work():
        if launch == "aten":
            return (x * 2).sum()
        return transfer.p2g_bin_keys(x, active, cfg.n_grid, cfg.inv_dx)

    work()
    torch.cuda.synchronize()
    with obs.tracing() as t, profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        for i in range(10):
            with obs.span(f"launch.{i}"):
                work()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if str(e.device_type()).endswith("CUDA")]
    runtime = {e.correlation_id(): e for e in events
               if e not in on_card and e.name().startswith("cu")}
    kernels = [e for e in on_card if not e.name().startswith(("pixie.", "Memcpy", "Memset"))]
    assert kernels
    spans = [(s, e) for name, _, s, e in t.records if name.startswith("launch.")]
    for k in kernels:
        at = runtime[k.correlation_id()].start_ns()
        assert any(s - CLOCK_NS <= at <= e + CLOCK_NS for s, e in spans), k.name()


@pytest.mark.cuda
def test_run_counts_on_the_card_match_the_cpu(cuda_device):
    st, cfg = _state(), _solver(False).cfg
    active = st.selection == 0
    order = transfer.cell_order(st.x, active, cfg)
    for x, a in ((st.x, active), (st.x[order], active[order])):
        want = [int(v) for v in fs.run_counts(x, a, cfg)]
        got = fs.run_counts(x.to(cuda_device), a.to(cuda_device), cfg)
        assert all(v.is_cuda for v in got) and [int(v) for v in got] == want
