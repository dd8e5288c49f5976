"""The capture stages and the Blender boundary of the port against the JAX
package's, on the CPU without Blender: the bpy scripts of
pixie_tpu_torch/blender/ (their code and their argument parsing), the
pipeline's download_assets and render_blender_images, render.py's Blender
modes and data_curation/render_pool.py.  Every Blender argv equals JAX's
apart from the script, which is the port's own copy; a recording
``blender`` (chip_smoke.recording_blender) stands in for the binary."""

import ast
import importlib.util
import json
import logging
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

import pipeline as jpipeline
import render as jrender
from chip_smoke import blender_script, recording_blender
from pixie_tpu.config import compose as jcompose
from pixie_tpu.data_curation import render_pool as jpool
from pixie_tpu.utils import proc as jproc
from pixie_tpu.utils.paths import get_output_paths as jget_output_paths
from pixie_tpu.utils.paths import resolve_paths as jresolve_paths
from pixie_tpu_torch import pipeline as tpipeline
from pixie_tpu_torch import render as trender
from pixie_tpu_torch.config import compose as tcompose
from pixie_tpu_torch.data_curation import render_pool as tpool
from pixie_tpu_torch.utils import proc as tproc
from pixie_tpu_torch.utils.paths import get_output_paths, resolve_paths

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPTS, TORCH_SCRIPTS = REPO / "pixie_tpu" / "blender", REPO / "pixie_tpu_torch" / "blender"
SCRIPTS = ["generate_blendernerf_data.py", "render_glb.py", "render_gs.py"]


def _is_port_script(path) -> bool:
    path = Path(path)
    return path.is_file() and path.resolve().parent == TORCH_SCRIPTS.resolve()


def _without_docstring(path: Path) -> str:
    tree = ast.parse(path.read_text())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        tree.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("script", SCRIPTS)
def test_bpy_script_is_jax_copy(script):
    assert _without_docstring(TORCH_SCRIPTS / script) == _without_docstring(JAX_SCRIPTS / script)


# ---- the scripts' argument parsing under stub bpy/mathutils modules --------

def _load(path: Path, name: str, monkeypatch):
    """Load a bpy script as a module with stub ``bpy`` and ``mathutils``
    (monkeypatch takes them out of sys.modules again)."""
    mathutils = types.ModuleType("mathutils")
    mathutils.Matrix, mathutils.Vector = type("Matrix", (), {}), type("Vector", (), {})
    monkeypatch.setitem(sys.modules, "bpy", types.ModuleType("bpy"))
    monkeypatch.setitem(sys.modules, "mathutils", mathutils)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARGVS = {
    "generate_blendernerf_data.py": [
        ["--glb", "a.glb", "--out", "data/x"],
        ["--glb", "a.glb", "--out", "o", "--num-views", "12", "--dist-min", "1.1",
         "--dist-max", "2.0", "--resolution", "64", "--format", "NGP", "--transparent-bg",
         "--blender-nerf-addon-path", "addon.zip"],
    ],
    "render_glb.py": [
        ["--obj", "m.glb", "--obj_id", "x", "--output_folder", "o"],
        ["--obj", "m.glb", "--obj_id", "x", "--output_folder", "o", "--views", "4",
         "--camera_id", "2", "--focal_length", "35", "--transparent", "--data_dir", "d"],
    ],
    "render_gs.py": [
        ["--obj_id", "x", "--ply_dir", "p", "--output_dir", "o", "--data_dir", "d",
         "--blender_gs_addon_path", "a.zip"],
        ["--obj_id", "x", "--ply_dir", "p", "--output_dir", "o", "--data_dir", "d",
         "--blender_gs_addon_path", "a.zip", "--init_xyz", "0", "1", "2", "--bg_color", "1",
         "0.5", "--place_on_ground", "--rotate_around", "30", "--num_renders", "3"],
    ],
}


@pytest.mark.parametrize("script,case", [(s, k) for s in SCRIPTS for k in range(2)])
def test_parse_args_matches_jax(script, case, monkeypatch):
    argv = ["blender", "-b", "-P", script, "--", *ARGVS[script][case]]
    monkeypatch.setattr(sys, "argv", argv)
    got = _load(TORCH_SCRIPTS / script, "torch_bpy_script", monkeypatch).parse_args()
    want = _load(JAX_SCRIPTS / script, "jax_bpy_script", monkeypatch).parse_args()
    assert got == want


@pytest.mark.parametrize("script", ["render_glb.py", "render_gs.py"])
def test_bpy_scripts_exit_without_blender(script, monkeypatch):
    """The import-time guard is kept: without bpy both copies exit."""
    monkeypatch.setitem(sys.modules, "bpy", None)
    for path in (TORCH_SCRIPTS / script, JAX_SCRIPTS / script):
        spec = importlib.util.spec_from_file_location("bpy_script", path)
        with pytest.raises(SystemExit, match="must run inside Blender"):
            spec.loader.exec_module(importlib.util.module_from_spec(spec))


# ---- the pipeline's capture stages -----------------------------------------

def _cfgs(tmp_path, extra=()):
    over = ["obj_id=obj_a", f"paths.base_path={tmp_path}", "data_rendering.num_views=12",
            "data_rendering.camera_dist_min=1.1", "data_rendering.resolution=64", *extra]
    jcfg = jresolve_paths(jcompose(overrides=over))
    tcfg = resolve_paths(tcompose(overrides=over))
    paths = get_output_paths(tcfg, tcfg.obj_id)
    assert paths == jget_output_paths(jcfg, jcfg.obj_id)
    Path(paths["data_dir"]).mkdir(parents=True, exist_ok=True)
    return jcfg, tcfg, paths


def _record_run_cmd(monkeypatch) -> dict:
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jproc, "run_cmd", lambda cmd, **kw: calls["jax"].append(list(cmd)))
    monkeypatch.setattr(tproc, "run_cmd", lambda cmd, **kw: calls["torch"].append(list(cmd)))
    return calls


def _render_both(jcfg, tcfg, paths):
    jpipeline.render_blender_images(jcfg, paths)
    tpipeline.render_blender_images(
        paths["data_dir"], tcfg.paths.data_dir, tcfg.obj_id, tcfg.data_rendering,
        blender=str(tcfg.paths.blender_path), overwrite=bool(tcfg.overwrite))


def _same_but_script(got: list, want: list, script_at: int) -> None:
    assert len(got) == len(want)
    assert got[:script_at] + got[script_at + 1:] == want[:script_at] + want[script_at + 1:]
    assert _is_port_script(got[script_at])
    assert Path(want[script_at]).name == Path(got[script_at]).name


@pytest.mark.parametrize("where", ["data_dir", "glb_dir"])
def test_render_blender_images_argv_matches_jax(where, tmp_path, monkeypatch):
    jcfg, tcfg, paths = _cfgs(tmp_path)
    glb_dir = Path(paths["data_dir"]) if where == "data_dir" else Path(tcfg.paths.data_dir)
    (glb_dir / "obj_a_v2.glb").write_bytes(b"glTF")
    monkeypatch.setattr(shutil, "which", lambda b: f"/usr/bin/{b}")
    calls = _record_run_cmd(monkeypatch)
    _render_both(jcfg, tcfg, paths)
    (got,), (want,) = calls["torch"], calls["jax"]
    _same_but_script(got, want, 3)
    assert want[3] == "pixie_tpu/blender/generate_blendernerf_data.py"
    assert got[3] == str(tpipeline.CAPTURE_SCRIPT) and Path(got[3]).is_absolute()
    assert got[got.index("--glb") + 1] == str(glb_dir / "obj_a_v2.glb")
    assert got[got.index("--num-views") + 1] == "12"
    assert got[got.index("--resolution") + 1] == "64"


@pytest.mark.parametrize("overwrite", [False, True])
def test_render_blender_images_skips_on_transforms(overwrite, tmp_path, monkeypatch):
    jcfg, tcfg, paths = _cfgs(tmp_path, [f"overwrite={str(overwrite).lower()}"])
    (Path(paths["data_dir"]) / "transforms.json").write_text("{}")
    (Path(paths["data_dir"]) / "obj_a.glb").write_bytes(b"glTF")
    monkeypatch.setattr(shutil, "which", lambda b: f"/usr/bin/{b}")
    calls = _record_run_cmd(monkeypatch)
    _render_both(jcfg, tcfg, paths)
    assert len(calls["torch"]) == len(calls["jax"]) == int(overwrite)


def test_render_blender_images_skips_without_blender(tmp_path, monkeypatch, caplog):
    jcfg, tcfg, paths = _cfgs(tmp_path)
    (Path(paths["data_dir"]) / "obj_a.glb").write_bytes(b"glTF")
    monkeypatch.setattr(shutil, "which", lambda b: None)
    calls = _record_run_cmd(monkeypatch)
    with caplog.at_level(logging.WARNING):
        _render_both(jcfg, tcfg, paths)
    assert calls == {"jax": [], "torch": []}
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs == ["[blender] blender binary not found; skipping render stage"] * 2


def test_render_blender_images_raises_without_glb(tmp_path, monkeypatch):
    jcfg, tcfg, paths = _cfgs(tmp_path)
    monkeypatch.setattr(shutil, "which", lambda b: f"/usr/bin/{b}")
    calls = _record_run_cmd(monkeypatch)
    with pytest.raises(FileNotFoundError) as want:
        jpipeline.render_blender_images(jcfg, paths)
    with pytest.raises(FileNotFoundError) as got:
        tpipeline.render_blender_images(paths["data_dir"], tcfg.paths.data_dir, tcfg.obj_id,
                                        tcfg.data_rendering)
    assert str(got.value) == str(want.value)
    assert calls == {"jax": [], "torch": []}


@pytest.mark.parametrize("case", ["non_empty", "no_objaverse", "fake_objaverse"])
def test_download_assets_matches_jax(case, tmp_path, monkeypatch, caplog):
    jcfg, tcfg, paths = _cfgs(tmp_path)
    loaded = []
    if case == "non_empty":
        (Path(paths["data_dir"]) / "obj_a.glb").write_bytes(b"glTF")
    if case == "fake_objaverse":
        fake = types.ModuleType("objaverse")
        fake.load_objects = loaded.append
        monkeypatch.setitem(sys.modules, "objaverse", fake)
    else:  # no download is ever tried
        monkeypatch.setitem(sys.modules, "objaverse", None)
    with caplog.at_level(logging.INFO):
        jpipeline.download_assets(jcfg, paths)
        n = len(caplog.records)
        tpipeline.download_assets(paths["data_dir"], tcfg.obj_id)
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs[:n] == msgs[n:] and n == (0 if case == "fake_objaverse" else 1)
    assert loaded == ([["obj_a"]] * 2 if case == "fake_objaverse" else [])
    if case == "no_objaverse":
        assert caplog.records[0].levelno == logging.WARNING
        assert "objaverse unavailable" in msgs[0]


# ---- render.py's Blender modes ---------------------------------------------

@pytest.mark.parametrize("mode", ["blender_gs", "blender_glb"])
@pytest.mark.parametrize("extra", [
    [],
    ["+paths.blend_file_path=/scenes/studio.blend", "overwrite=true",
     "output_rendering.blender_render_gs.transparent=true",
     "output_rendering.blender_render_gs.bg_color=[1,1,1]",
     "output_rendering.blender_render_glb.transparent=true", "physics.sample_id=3"],
], ids=["defaults", "overrides"])
def test_render_blender_argv_matches_jax(mode, extra, tmp_path, monkeypatch):
    jcfg, tcfg, paths = _cfgs(tmp_path, extra)
    calls = _record_run_cmd(monkeypatch)
    want_dir = jrender.render_blender(jcfg, paths, mode)
    got_dir = trender.render_blender(tcfg, paths, mode)
    assert got_dir == want_dir
    (got,), (want,) = calls["torch"], calls["jax"]
    _same_but_script(got, want, 3)
    assert Path(want[3]).resolve() == (JAX_SCRIPTS / Path(got[3]).name).resolve()


# ---- data_curation/render_pool.py ------------------------------------------

DATASETS = [
    ({"chair": ["a", "b", "c"], "plant": ["d"]}, dict(max_objs_per_class=2, num_gpus=2)),
    ({"tree": [f"t{i}" for i in range(5)], "jelly": ["j0", "j1"]},
     dict(obj_class="tree", num_gpus=0, blender_path="/usr/local/blender/blender", resolution=256,
          views=50)),
    ({"sand": ["s0", "s1", "s2"], "metal": ["m0"], "cloth": []}, dict(num_gpus=1)),
]


@pytest.mark.parametrize("k", range(len(DATASETS)))
def test_build_render_jobs_matches_jax(k, tmp_path):
    dataset, kw = DATASETS[k]
    got = tpool.build_render_jobs(dataset, tmp_path / "glb", tmp_path / "out", **kw)
    assert got == jpool.build_render_jobs(dataset, tmp_path / "glb", tmp_path / "out", **kw)
    assert got


def _fake_render(job):
    # module-level, so the pool's workers can unpickle it
    return job["uid"] != "b"


def _crashing_render(job):
    if job["uid"] == "b":
        raise RuntimeError("render crashed")
    return True


@pytest.mark.parametrize("worker", [_fake_render, _crashing_render])
def test_render_pool_reports_each_job(worker, tmp_path):
    jobs = [{"uid": u, "glb": "x.glb", "output_dir": str(tmp_path / u)} for u in "abc"]
    assert tpool.render_pool(jobs, num_workers=2, worker_fn=worker) == [True, False, True]


def test_render_object_skips_rendered(tmp_path, monkeypatch):
    calls = _record_run_cmd(monkeypatch)
    (tmp_path / "done").mkdir()
    (tmp_path / "done" / "0.png").write_bytes(b"")
    job = {"uid": "x", "glb": "missing.glb", "output_dir": str(tmp_path / "done")}
    assert tpool.render_object(job) and jpool.render_object(job)
    assert calls == {"jax": [], "torch": []}


@pytest.mark.parametrize("gpu_id,fails", [(None, False), (1, False), (0, True)])
def test_render_object_argv_matches_jax(gpu_id, fails, tmp_path, monkeypatch):
    calls = {"jax": [], "torch": []}

    def recorder(name, error):
        def run_cmd(cmd, env=None, echo=True):
            calls[name].append((list(cmd), env.get("CUDA_VISIBLE_DEVICES"), echo))
            if fails:
                raise error("rc=1")
        return run_cmd

    monkeypatch.setattr(jproc, "run_cmd", recorder("jax", jproc.CommandError))
    monkeypatch.setattr(tproc, "run_cmd", recorder("torch", tproc.CommandError))
    results = []
    for name, pool in (("jax", jpool), ("torch", tpool)):
        job = {"uid": "u1", "glb": str(tmp_path / "u1.glb"),
               "output_dir": str(tmp_path / name / "u1"), "gpu_id": gpu_id, "views": 8}
        results.append(pool.render_object(job))
    assert results == [not fails] * 2
    ((got, got_gpu, got_echo),), ((want, want_gpu, want_echo),) = calls["torch"], calls["jax"]
    assert (got_gpu, got_echo) == (want_gpu, want_echo)
    assert got_gpu == (None if gpu_id is None else str(gpu_id))
    got[got.index("--out") + 1] = want[want.index("--out") + 1]
    _same_but_script(got, want, 3)


# ---- the pipeline CLI from outside the repository -------------------------

def seed_later_stages(base: Path, obj: str) -> None:
    """Outputs of every stage after the capture, so that ``main`` skips them."""
    for f in (f"models/{obj}/f3rm/checkpoints/field.pth",
              f"render_outputs/{obj}/clip_features_features.npy",
              f"render_outputs/{obj}/clip_features_mask.npy",
              f"render_outputs/{obj}/sample_0/mapped_preds.ply",
              f"mpm_sim_outputs/neural/{obj}/sample_0/sim_info.json"):
        (base / f).parent.mkdir(parents=True, exist_ok=True)
        (base / f).write_bytes(b"")
    (base / "models" / obj / "gs" / "point_cloud").mkdir(parents=True)


def test_pipeline_cli_runs_the_ports_capture_script(tmp_path):
    base, obj = tmp_path / "base", "obj_cli"
    (base / "data" / obj).mkdir(parents=True)
    (base / "data" / obj / f"{obj}.glb").write_bytes(b"glTF")  # download_assets skips
    seed_later_stages(base, obj)
    blender = recording_blender(tmp_path / "bin")
    env = {**os.environ, "PATH": f"{blender.parent}{os.pathsep}{os.environ['PATH']}",
           "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-m", "pixie_tpu_torch.pipeline", f"obj_id={obj}",
                          f"paths.base_path={base}", "--cpu"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (argv,) = [json.loads(line) for line in (blender.parent / "argv.jsonl").read_text().splitlines()]
    assert blender_script(argv) == tpipeline.CAPTURE_SCRIPT
    assert argv[argv.index("--glb") + 1] == str(base / "data" / obj / f"{obj}.glb")
    assert (base / "data" / obj / "transforms.json").exists()
    assert "pipeline stages complete" in out.stderr
