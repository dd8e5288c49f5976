"""The port's render entry point (pixie_tpu_torch/render.py) and the
utilities it and the pipeline use (utils/viz.py, mesh_paint.py, proc.py,
observability.py) against the root render.py and the JAX package's, on
small seeded fixtures on the CPU."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import render as jrender
from pixie_tpu.utils import mesh_paint as jmesh
from pixie_tpu.utils import observability as jobs
from pixie_tpu.utils import viz as jviz
from pixie_tpu_torch import render as trender
from pixie_tpu_torch.utils import mesh_paint as tmesh
from pixie_tpu_torch.utils import observability as tobs
from pixie_tpu_torch.utils import proc as tproc
from pixie_tpu_torch.utils import viz as tviz
from pixie_tpu_torch.utils.io import make_material_vertex, write_ply
import test_aux

REPO = Path(__file__).resolve().parent.parent


def _cfgs(overrides):
    from pixie_tpu.config import compose as jcompose
    from pixie_tpu_torch.config import compose as tcompose

    return jcompose(overrides=overrides), tcompose(overrides=overrides)


@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_render_pointcloud_image_and_cuboid_identical(labels, axis):
    rng = np.random.default_rng(axis)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    kw = dict(labels=rng.integers(0, 12, 500)) if labels else {}
    got = tviz.render_pointcloud_image(pts, res=64, axis=axis, point_size=3, **kw)
    want = jviz.render_pointcloud_image(pts, res=64, axis=axis, point_size=3, **kw)
    np.testing.assert_array_equal(got, want)
    lo, span = pts.min(0)[[a for a in range(3) if a != axis]], 4.0
    np.testing.assert_array_equal(
        tviz.draw_cuboid_outline(got.copy(), [0.1, 0.2, 0.0], [0.5, 0.4, 0.3], lo, span, 64,
                                 axis=axis),
        jviz.draw_cuboid_outline(want.copy(), [0.1, 0.2, 0.0], [0.5, 0.4, 0.3], lo, span, 64,
                                 axis=axis))
    assert (tviz.render_pointcloud_image(np.zeros((0, 3)), res=8) == 1.0).all()


def _write_frames(sim_dir: Path, n: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    (sim_dir / "ply_files").mkdir(parents=True)
    for k in range(n):
        pts = rng.uniform(-0.4, 0.4, (300, 3)).astype(np.float32)
        write_ply(sim_dir / "ply_files" / f"frame_{k:04d}.ply", make_material_vertex(
            coords=pts, density=np.full(300, 300.0, np.float32),
            E=np.full(300, 1e5, np.float32), nu=np.full(300, 0.3, np.float32),
            material_id=rng.integers(0, 7, 300)))


def test_sim_mode_pngs_identical(tmp_path):
    names = {}
    for name, mod, cfg in zip(("jax", "torch"), (jrender, trender),
                              _cfgs(["obj_id=obj", "material_mode=vlm",
                                     f"paths.base_path={tmp_path}",
                                     "physics.compile_video=false"])):
        paths = {"physgaussian_output": str(tmp_path / name)}
        _write_frames(tmp_path / name / "sample_0")
        out = mod.render_sim_frames(cfg, paths, res=96)
        names[name] = sorted(p.name for p in Path(out).glob("*.png"))
    assert names["jax"] == names["torch"] == ["frame_0000.png", "frame_0001.png"]
    for n in names["jax"]:
        got = (tmp_path / "torch" / "sample_0" / "frames" / n).read_bytes()
        assert got == (tmp_path / "jax" / "sample_0" / "frames" / n).read_bytes(), n


@pytest.fixture
def captured(monkeypatch):
    """The float images each render.py hands to its PNG writer."""
    shots = {"jax": [], "torch": []}
    monkeypatch.setattr(jrender, "_save_png", lambda p, img: shots["jax"].append(
        np.asarray(img, np.float32)))
    monkeypatch.setattr(trender, "_save_png", lambda p, img: shots["torch"].append(
        np.asarray(img, np.float32)))
    return shots


def test_render_gs_views_matches_jax(tmp_path, captured):
    from pixie_tpu_torch.recon.gaussians import save_gaussian_ply

    rng = np.random.default_rng(4)
    n = 150
    params = {"xyz": rng.uniform(-0.4, 0.4, (n, 3)), "f_dc": rng.normal(0, 1, (n, 1, 3)),
              "f_rest": rng.normal(0, 0.1, (n, 15, 3)),
              "scaling": np.log(rng.uniform(0.02, 0.08, (n, 3))),
              "rotation": rng.normal(size=(n, 4)), "opacity": rng.normal(0, 1, (n, 1))}
    ply = tmp_path / "gs" / "point_cloud" / "iteration_30" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    save_gaussian_ply(ply, {k: torch.as_tensor(v.astype(np.float32)) for k, v in params.items()})
    paths = {"gs_output": str(tmp_path / "gs"), "render_output": str(tmp_path / "render")}
    jcfg, tcfg = _cfgs(["obj_id=obj"])
    jrender.render_gs_views(jcfg, paths, n_views=3, res=40)
    trender.render_gs_views(tcfg, paths, n_views=3, res=40, device="cpu")
    assert len(captured["torch"]) == len(captured["jax"]) == 3
    for got, want in zip(captured["torch"], captured["jax"]):
        assert got.shape == (40, 40, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.ptp(captured["jax"][0]) > 0.05                # the splats are seen


def test_render_nerf_views_matches_jax(tmp_path, captured, monkeypatch):
    """The port reads its field checkpoint; JAX gets the same parameters as
    a flax tree (its checkpoint is orbax's)."""
    from pixie_tpu.recon import field_adapter as jfa
    from pixie_tpu_torch.recon.field import NerfField
    from pixie_tpu_torch.recon.train_field import save_field_checkpoint
    from test_torch_voxelize import _flax_tree, _seeded_sd

    nsd = _seeded_sd(NerfField(), 30, density_bias=1.0)
    nerf = NerfField()
    nerf.load_state_dict(nsd)
    save_field_checkpoint(tmp_path / "f3rm", {"nerf": nerf}, feature_dim=768)
    monkeypatch.setattr(jfa, "load_field_adapter",
                        lambda out: jfa.FieldAdapter(_flax_tree(nsd), None))
    paths = {"nerf_output": str(tmp_path / "f3rm"), "render_output": str(tmp_path / "render")}
    jcfg, tcfg = _cfgs(["obj_id=obj"])
    jrender.render_nerf_views(jcfg, paths, n_views=2, res=12)
    trender.render_nerf_views(tcfg, paths, n_views=2, res=12, device="cpu")
    assert len(captured["torch"]) == len(captured["jax"]) == 2
    for got, want in zip(captured["torch"], captured["jax"]):
        assert got.shape == (12, 12, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.ptp(captured["jax"][0]) > 1e-3


def test_main_renders_and_skips_blender(tmp_path, caplog):
    """``main`` with the sim mode and the Blender modes (no Blender binary
    here: skipped with a warning, as in JAX); an unknown mode raises."""
    base = ["obj_id=obj", f"paths.base_path={tmp_path}", "physics.compile_video=false",
            "paths.blender_path=/nonexistent/blender"]
    _write_frames(tmp_path / "mpm_sim_outputs" / "neural" / "obj" / "sample_0", n=1)
    trender.main(base + ["+render_modes=[sim,blender_gs,blender_glb]"], device="cpu")
    frame = tmp_path / "mpm_sim_outputs" / "neural" / "obj" / "sample_0" / "frames" / \
        "frame_0000.png"
    assert np.asarray(Image.open(frame)).shape == (512, 512, 3)
    assert "blender not found; skipping blender_gs" in caplog.text
    with pytest.raises(ValueError, match="unknown render mode"):
        trender.main(base + ["+render_modes=[bogus]"], device="cpu")


def test_paint_mesh_outputs_identical(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.4, 0.4, (300, 3)).astype(np.float32)
    mats = (pts[:, 0] > 0).astype(np.int64) * 6
    write_ply(tmp_path / "mapped_preds.ply", make_material_vertex(
        coords=pts, density=rng.uniform(100, 900, 300).astype(np.float32),
        E=np.where(mats == 6, 1e7, 1e5).astype(np.float32),
        nu=rng.uniform(0.2, 0.45, 300).astype(np.float32), material_id=mats))
    test_aux.TestMeshPaint._write_glb(tmp_path / "obj.glb", (pts * 3.0 + 5.0).astype(np.float32),
                             translation=[0.5, 0.0, -1.0])
    np.testing.assert_array_equal(tmesh.load_glb_vertices(tmp_path / "obj.glb"),
                                  jmesh.load_glb_vertices(tmp_path / "obj.glb"))
    outs = {}
    for name, mod in (("jax", jmesh), ("torch", tmesh)):
        outs[name] = mod.paint_mesh_with_predictions(
            tmp_path / "obj.glb", tmp_path / "mapped_preds.ply", tmp_path / name,
            turntable_frames=2)
    assert set(outs["torch"]) == set(outs["jax"])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "torch")
                           for p in (tmp_path / "torch").rglob("*") if p.is_file())
    assert len(files) > 4
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def _py(snippet: str):
    return [sys.executable, "-c", snippet]


@pytest.mark.parametrize("snippet, kw, raises, expect", [
    ("print('hello world')", {}, None, "hello world"),
    ("import sys; sys.exit(3)", {}, "rc=3", None),
    ("print('Traceback (most recent call last)')", {}, "Traceback", None),
    ("import sys; sys.exit(1)", {"allow_error": True}, None, ""),
    ("print('RuntimeError: add-on not loaded')", {}, None, "add-on"),
    ("print('Exception in module unregister():');print('Video saved to /tmp/x.mp4')", {}, None,
     "Video saved"),
], ids=["success", "nonzero_exit", "error_pattern", "allow_error", "line_whitelist",
        "allowlisted_combo"])
def test_run_cmd_cases_of_test_proc(snippet, kw, raises, expect):
    if raises:
        with pytest.raises(tproc.CommandError, match=raises):
            tproc.run_cmd(_py(snippet), echo=False, **kw)
        return
    out = tproc.run_cmd(_py(snippet), echo=False, **kw)
    assert (out == expect) if expect == "" else (expect in out)


@pytest.mark.parametrize("text, forgiven", [
    ("Exception in module unregister():\nRuntimeError: boom\nVideo saved to /x/y.mp4\n", True),
    ("Exception in module unregister():\n", False),
    ("BlenderNeRF Camera not found\nBlender quit\n", True),
    ("RuntimeError: real failure\n", False)])
def test_contextual_allowlist_cases_of_test_proc(text, forgiven):
    assert tproc._is_allowlisted_noise(text) is forgiven


def test_phase_timer_and_profiler_ranges():
    timer = tobs.PhaseTimer(use_profiler=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.phase("p2g", block_on=torch.zeros(2)):
                torch.ones(64).sum()
        with timer.phase("g2p"):
            pass
    summary = timer.summary()
    assert summary["p2g"]["calls"] == 3 and summary["g2p"]["calls"] == 1
    assert all(v["total_s"] >= 0 for v in summary.values())
    names = {e.key for e in prof.key_averages()}
    assert {"p2g", "g2p"} <= names
    timer.print_time_profile()
    # off (the default): no range, the same accounting
    assert tobs.PhaseTimer().use_profiler is False
    assert jobs.PhaseTimer().use_jax_profiler is False


def test_debug_particle_positions_and_logger_identical(tmp_path):
    x = np.array([[0.1, 0.2, 0.3], [-0.1, 0.5, 0.5], [0.5, 2.5, 0.1]], np.float32)
    for arr in (x, x[:1]):
        want = jobs.debug_particle_positions(arr, 2.0, "s")
        assert tobs.debug_particle_positions(arr, 2.0, "s") == want
        assert tobs.debug_particle_positions(torch.as_tensor(arr), 2.0, "s") == want
    for name, mod in (("jax", jobs), ("torch", tobs)):
        log = mod.ExperimentLogger(tmp_path / name, config={"lr": 1e-4}, use_wandb=False)
        log.log({"loss": np.float32(0.5), "acc": 1}, step=3)
        log.log({"loss": torch.tensor(0.25).item()}, step=4)
        log.finish()
        mod.ExperimentLogger(tmp_path / f"{name}_rank1", use_wandb=False, rank=1).log({"a": 1})
        assert not (tmp_path / f"{name}_rank1").exists()
    for f in ("metrics.jsonl", "run_config.json"):
        assert (tmp_path / "torch" / f).read_text() == (tmp_path / "jax" / f).read_text()
    rec = [json.loads(s) for s in (tmp_path / "torch" / "metrics.jsonl").read_text().split("\n")
           if s]
    assert rec == [{"step": 3, "loss": 0.5, "acc": 1.0}, {"step": 4, "loss": 0.25}]
