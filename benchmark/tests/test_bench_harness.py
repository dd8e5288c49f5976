"""CPU tests of the benchmark's harness (benchmark/): the cells resolve to
their files, the frozen counts match the nets and the state they count, the
plain references agree with the port at a tiny size, the controls and the
planted faults come out as not correct, and nothing loads JAX.

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need the card and skip here."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import counts, harness, trace
from benchmark.reference import unet as ref_unet

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]

# tiny cells for the CPU: the scene at 3000 particles on a 24^3 grid with
# 40-substep frames; the nets at 16^3 x 48 features, 8 channels, two levels
TINY_SCENE = {"n_particles": 3000, "n_grid": 24, "substeps_per_frame": 40}
TINY_NET = {"grid_size": 16, "feature_channels": 48, "model_channels": 8, "num_res_blocks": 1,
            "channel_mult": [1, 2]}
# the tiny scene's own limits: its float32 rounding reads up to x 4e-5 cell,
# v 1.1e-2, C 1.5e-2, F 1.2e-5 (the float32 reference reads the same); the
# bfloat16 control 6e-2 cell, 0.24, 0.67, 5e-4
TINY_SCENE_LIMITS = {"x_gap.impulse": 1e-3, "v_gap.impulse": 0.05, "F_gap.impulse": 5e-5,
                     "x_gap": 5e-3, "v_gap": 0.05, "C_gap": 0.1, "F_gap.sand": 2e-4,
                     "F_gap.snow": 5e-5, "F_gap.plasticine": 5e-5}
SEED = 2**31 + 977


def _overrides(cell: str) -> dict:
    if cell.startswith("tree_neural"):
        return {"config": dict(TINY_NET), "traffic": {"pool": 2}}
    return {"config": dict(TINY_SCENE), "limits": dict(TINY_SCENE_LIMITS)}


def run_tiny(cell: str, control=None, fault=None, trace=False) -> dict:
    # the material cell's window takes several objects, so each grid of the pool is served
    seconds = 0.5 if cell.startswith("tree_neural") else 0.0
    return harness.run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                            overrides=_overrides(cell), control=control, fault=fault)


# -- BENCHMARK.json and the files it names ---------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    r = harness.resolve(SPEC, cell)
    assert (ROOT / "benchmark" / "drivers" / f"{r['traffic']['driver']}.py").exists()
    assert {m["name"] for m in r["end_to_end"]} >= {"setup_s"} and len(r["end_to_end"]) >= 2
    assert r["per_layer"], cell
    e2e = {m["name"] for m in r["end_to_end"]}
    for m in r["end_to_end"] + r["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]
    for m in r["per_layer"]:
        assert m["moves"] in e2e, (cell, m["name"])


def test_benchmark_json_shape():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert name.match(w["name"]) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert name.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert len(json.dumps(SPEC)) < 64 * 1024


# -- the frozen counts ---------------------------------------------------------------------

def _tiny_net_cfg(**kw) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / "tree_neural.json").read_text())
    cfg.update(TINY_NET, **kw)
    return cfg


@pytest.mark.parametrize("kw", [{}, {"attention_resolutions": [2], "channel_mult": [1, 2, 2]}])
def test_unet_flops_match_conv3d_hooks(kw):
    from pixie_tpu_torch.models.unet3d import SegmentationUNet

    cfg = _tiny_net_cfg(**kw)
    net = SegmentationUNet(num_classes=cfg["num_classes"], feature_channels=cfg["feature_channels"],
                           cond_dim=cfg["cond_dim"], model_channels=cfg["model_channels"],
                           num_res_blocks=cfg["num_res_blocks"],
                           channel_mult=tuple(cfg["channel_mult"]),
                           attention_resolutions=tuple(cfg["attention_resolutions"]),
                           grid_size=cfg["grid_size"])
    seen = []

    def hook(m, _inp, out):
        seen.append(2 * m.in_channels * m.out_channels * int(np.prod(m.kernel_size))
                    * int(np.prod(out.shape[2:])) // m.groups)

    for m in net.modules():
        if isinstance(m, torch.nn.Conv3d):
            m.register_forward_hook(hook)
    side = cfg["grid_size"]
    with torch.no_grad():
        net(torch.zeros(1, side, side, side, cfg["feature_channels"]))
    assert sum(seen) == counts.unet_flops(cfg, cfg["num_classes"])["conv3d"]


@pytest.mark.parametrize("size", ["tiny", "shipped"])
def test_reference_net_keys_match_the_program(size):
    from pixie_tpu_torch.models.unet3d import RegressionUNet

    cfg = _tiny_net_cfg() if size == "tiny" else json.loads(
        (ROOT / "benchmark" / "configs" / "tree_neural.json").read_text())
    with torch.device("meta"):
        net = RegressionUNet(out_channels=3, feature_channels=cfg["feature_channels"],
                             cond_dim=cfg["cond_dim"], model_channels=cfg["model_channels"],
                             num_res_blocks=cfg["num_res_blocks"],
                             channel_mult=tuple(cfg["channel_mult"]),
                             attention_resolutions=tuple(cfg["attention_resolutions"]),
                             grid_size=cfg["grid_size"])
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {k: s for k, s, _ in ref_unet.param_specs(cfg, 3)}
    assert got == want
    if size == "shipped":
        assert sum(int(np.prod(s)) for s in got.values()) == pytest.approx(62.7e6, rel=2e-3)


def test_substep_bytes_match_the_state_they_count():
    from pixie_tpu_torch.sim.types import make_state

    n, g = 1000, 24
    st = make_state(np.random.default_rng(0).uniform(0.5, 1.5, (n, 3)), np.full(n, 1e-4))
    carried = sum(getattr(st, k).nbytes for k in ("x", "v", "C", "F", "mu", "lam", "yield_stress"))
    read_only = sum(getattr(st, k).nbytes for k in ("mass", "vol", "material")) + n  # + active
    grid = g ** 3 * 4 * 4                                     # momentum xyz + mass, float32
    assert counts.substep_work(n, g)[1] == 2 * carried + read_only + 2 * grid


def test_summary_reads_busy_idle_and_names_gaps():
    class Ev:
        def __init__(self, kind, name, s, d):
            self._k, self._n, self._s, self._d = kind, name, s, d

        def device_type(self):
            return f"DeviceType.{self._k}"

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d

    events = [Ev("CPU", "bench.substeps", 0, 1000), Ev("CUDA", "bench.substeps", 0, 1000),
              Ev("CPU", "aten::mul", 120, 60), Ev("CUDA", "k1(float*)", 0, 100),
              Ev("CUDA", "k2(float*)", 200, 100), Ev("CUDA", "Memcpy DtoH", 300, 100),
              Ev("CUDA", "k1(float*)", 600, 400)]
    prof = type("P", (), {"profiler": type("K", (), {
        "kineto_results": type("R", (), {"events": lambda self: events})()})()})()
    t = trace.summarize(prof, 1e-6, 4)
    assert t.launches == 3 and t.busy_s == pytest.approx(700e-9) and t.work == 4
    assert t.kernels["k1(float*)"] == [2, pytest.approx(500e-9)]
    assert trace.idle_gaps(prof) == [["bench.substeps/python", pytest.approx(200e-9)],
                                     ["bench.substeps/aten::mul", pytest.approx(100e-9)]]


# -- the references against the port, the controls, the faults ----------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and "setup_s" in res["metrics"]


def test_traced_run_has_its_three_parts():
    traffic = harness.resolve(SPEC, "scene_500k.rollout")["traffic"]
    res = run_tiny("scene_500k.rollout", trace=True)
    # untraced (at least the checked frame), then device-only traced (the naming frames
    # of the host-traced part are not units of the window)
    want = max(traffic["trace_units"], traffic["check_unit"] + 1) + traffic["trace_units"]
    assert res["correct"] and res["attempted"] == len(res["unit_s"]) == want
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("scene")])
def test_bfloat16_control_is_not_correct(cell):
    res = run_tiny(cell, control="bfloat16")
    assert not res["correct"]
    assert res["checks"]["x_gap"]["value"] > 3 * TINY_SCENE_LIMITS["x_gap"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 and the cells' own sizes exist only on the card")
    return "cuda:0"


@pytest.mark.cuda
def test_tf32_control_is_not_correct(card):
    res = harness.run_cell("tree_neural.material", SEED, 0.0, False, card,
                           time.perf_counter(), overrides={"config": {"grid_size": 32}},
                           control="tf32")
    assert not res["correct"], res["checks"]


# the faults each driver plants in its window (drivers/<driver>.py FAULTS); the exchange
# between chips has none to plant: every cell runs on one chip
FAULT_NAMES = ("state_unchanged", "half_left_out", "answer_altered")


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULT_NAMES])
def test_planted_fault_is_not_correct(cell, fault):
    res = run_tiny(cell, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULT_NAMES])
def test_planted_fault_at_the_cells_size_is_not_correct(cell, fault, card):
    # the cell as the benchmark runs it, against its committed limits (PERF.md lists the
    # readings); the material cell's window takes several objects, so a stale one shows
    seconds = 3.0 if cell.startswith("tree_neural") else 0.0
    res = harness.run_cell(cell, SEED, seconds, False, card, time.perf_counter(), fault=fault)
    assert not res["correct"], res["checks"]


def test_no_jax_module_after_a_run():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "harness.run_cell('tree_neural.material', 3, 0.0, False, 'cpu', time.perf_counter(),"
        " overrides={'config': %r, 'traffic': {'pool': 1}})\n"
        "import benchmark.drivers.mpm_rollout, pixie_tpu_torch.sim.solver\n"
        "print(harness.forbidden_modules())\n" % (str(ROOT), TINY_NET))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
