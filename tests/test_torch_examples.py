"""The port's examples (pixie_tpu_torch/examples/) on the CPU at their
smallest flags: jelly_drop against the repo's examples/jelly_drop.py (the
JAX package) at the same arguments, the others for the artifacts they
write.  ``pipeline_cli_e2e`` (and ``walkthrough`` when it has to run it)
takes over two minutes here (the shipped U-Net width and two CLI runs of
every stage), so its CPU run is left to chip_smoke.py's phase 11; the
walkthrough runs here on the artifacts ``pixie_e2e`` writes, which are
the ones it reads."""

import importlib.util
import sys
from pathlib import Path

import numpy as np

from pixie_tpu_torch.examples import jelly_drop, pixie_e2e, real_scene_walkthrough, walkthrough
from pixie_tpu_torch.utils.io import read_ply

REPO = Path(__file__).resolve().parent.parent


def _xyz(path):
    v = read_ply(path)["vertex"]
    return np.column_stack([v["x"], v["y"], v["z"]])


def test_jelly_drop_matches_jax_example(tmp_path, monkeypatch):
    """500 particles, 2 frames of 10 substeps: the frame-1 PLY's positions
    within 1e-5 of examples/jelly_drop.py --cpu's."""
    args = ["--cpu", "--particles", "500", "--frames", "2", "--substeps", "10"]
    got = jelly_drop.main(args + ["--out", str(tmp_path / "t")])
    assert [p.name for p in got["plys"]] == ["frame_0001.ply"]
    spec = importlib.util.spec_from_file_location("jax_jelly_drop",
                                                  REPO / "examples" / "jelly_drop.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["jelly_drop.py", *args, "--out", str(tmp_path / "j")])
    mod.main()
    want = _xyz(tmp_path / "j" / "frame_0001.ply")
    np.testing.assert_allclose(_xyz(got["plys"][0]), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["x"], want, rtol=0, atol=1e-5)
    assert want[:, 2].min() > 0.5        # above the pinned ground slab


def test_pixie_e2e_then_walkthrough(tmp_path):
    """pixie_e2e at small flags writes the field, voxels, U-Nets, the
    material PLY, the rollout and its frames; walkthrough then renders its
    sections from those artifacts."""
    out = tmp_path / "e2e"
    res = pixie_e2e.main(["--cpu", "--out", str(out), "--field-iters", "20",
                          "--unet-steps", "1", "--frames", "2"])
    assert res["mapped_ply"].exists() and res["sim_info"].exists()
    assert len(res["frames"]) == 2 and all(p.exists() for p in res["frames"])
    assert all(Path(p).exists() for p in res["ckpts"].values())
    wt = walkthrough.main(["--cpu", "--out", str(out)])
    names = {p.name for p in wt["pngs"]}
    assert {"01_field_render.png", "01_field_gt.png", "02_voxel_pc.png",
            "04_material_field.png"} <= names
    assert np.isfinite(wt["psnr"])


def test_real_scene_walkthrough(tmp_path):
    res = real_scene_walkthrough.main(["--cpu", "--out", str(tmp_path / "rs"), "--iters", "4"])
    assert res["dataparser"].exists()
    assert (res["field"] / "checkpoints" / "field.pth").exists()
    assert any(res["gs"].rglob("point_cloud.ply"))
