"""The whole slice, port vs JAX package, on one synthetic object:
voxel grid -> U-Nets -> sample_0_pred.npy -> mapped_preds.ply -> MPM rollout
-> frame PLYs (shape of tests/test_pipeline_stages.py:36 and
tests/test_voxel_sim_e2e.py:262-305).

The object: a 16^3 grid with a ball mask, 48-channel float16 features and
seeded U-Net weights; the regression head's output conv is scaled by 1e-3
so that the denormalized E (~9e6 Pa) stays in the range an explicit step at
substep_dt 1e-4 holds.  The JAX side runs CombinedInference (the two nets,
not the lane-packed joint net: the JAX package states the same math) ->
infer_single_device -> map_pred_to_ply -> run_simulation on the XLA solver.

Tolerances: class channels and material ids identical; continuous channels
atol 1e-5 (float32 nets, outputs of magnitude ~1e-3 after the head scale);
boundary_conditions.json equal; frame positions atol 2e-5 in world units
(object size ~1) after 60 substeps.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets the torch thread count)

REPO = Path(__file__).resolve().parent.parent
D, FC, OBJ = 16, 48, "ballobj"
MODEL_KW = dict(cond_dim=32, model_channels=16, num_res_blocks=1, channel_mult=(1, 2))


def _make_object(root: Path, model_kw=MODEL_KW):
    from pixie_tpu_torch.models.unet3d import RegressionUNet, SegmentationUNet, seeded_state_dict

    render = root / "render_outputs" / OBJ
    render.mkdir(parents=True)
    rng = np.random.default_rng(0)
    c = (np.arange(D) - (D - 1) / 2.0)
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    mask = (r < 6.5).astype(np.float32)
    feats = rng.normal(size=(D, D, D, FC)).astype(np.float16) * mask[..., None].astype(np.float16)
    np.save(render / "clip_features_features.npy", feats)
    np.save(render / "clip_features_mask.npy", mask)
    np.savez(render / "clip_features.npz", min_bounds=np.full(3, -0.5, np.float32),
             max_bounds=np.full(3, 0.5, np.float32), grid_shape=np.array([D, D, D]))
    kw = dict(feature_channels=FC, grid_size=D, **model_kw)
    sds = {}
    # checkpoint dirs named as the config tree's paths.*_checkpoint_dir
    for name, model, scale in (("discrete", SegmentationUNet(num_classes=8, **kw), 1.0),
                               ("continuous_mse", RegressionUNet(out_channels=3, **kw), 1e-3)):
        sd = seeded_state_dict(model, seed=len(sds) + 5, head_scale=scale)
        ckpt = root / f"checkpoints_{name}"
        ckpt.mkdir()
        torch.save({"model_state_dict": sd}, ckpt / "epoch_3.pth")
        sds[name] = sd
    cfg = json.loads((REPO / "config/objaverse/custom_tree_config.json").read_text())
    cfg.update(frame_dt=2e-3, frame_num=3)  # 20 substeps a frame, 3 frames
    # the shipped impulse moves particles by ~1e-10 in 60 substeps, below
    # float32 resolution; 1e4 times the force makes the rollout move (~1e-3)
    cfg["boundary_conditions"][0]["force"] = [-4800.0, 0.0, 1200.0]
    sim_cfg = root / "sim.json"
    sim_cfg.write_text(json.dumps(cfg))
    return render, mask, feats, sds, sim_cfg


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    render, mask, feats, sds, sim_cfg = _make_object(root)
    ranges_path = REPO / "normalization_stats" / "normalization_ranges.yaml"

    # -- JAX package --
    import jax.numpy as jnp

    from pixie_tpu.models.convert_torch import convert_state_dict
    from pixie_tpu.sim.driver import run_simulation
    from pixie_tpu.train.inference import CombinedInference, infer_single_device
    from pixie_tpu.utils.norm import load_normalization_ranges
    from pixie_tpu.voxel.map_pred_to_coords import map_pred_to_ply

    conv = {k: convert_state_dict(sd, num_res_blocks=1, channel_mult=(1, 2))["params"]
            for k, sd in sds.items()}
    infer = CombinedInference(conv["discrete"], conv["continuous_mse"], grid_size=D,
                              feature_channels=FC, model_kwargs=MODEL_KW, use_joint=False)
    jdir = root / "jax"
    pred = infer_single_device(infer, jnp.asarray(feats), mask, OBJ, 0, jdir / "neural")
    jply = jdir / "mapped_preds.ply"
    map_pred_to_ply(pred, render / "clip_features_mask.npy", render / "clip_features.npz",
                    jply, OBJ, load_normalization_ranges(ranges_path))
    jinfo = run_simulation(jply, sim_cfg, jdir / "sim", debug=True, use_fast_solver=False)

    # -- port --
    from pixie_tpu_torch import pipeline

    tdir = root / "torch"
    tply = pipeline.generate_neural_segmentation(
        render, tdir / "neural", OBJ, root / "checkpoints_discrete",
        root / "checkpoints_continuous_mse", ranges_path=ranges_path, grid_size=D,
        feature_channels=FC, model_kwargs=MODEL_KW, device="cpu")
    tinfo = pipeline.run_physics_simulation(tply, sim_cfg, tdir / "sim", debug=True,
                                            device="cpu")
    return {"jax": (jdir, pred, jply, jinfo), "torch": (tdir, tply, tinfo), "mask": mask}


def test_prediction_grid(slice_runs):
    _, jpred, _, _ = slice_runs["jax"]
    tdir = slice_runs["torch"][0]
    want = np.load(jpred)
    got = np.load(tdir / "neural" / OBJ / "sample_0_pred.npy")
    assert got.shape == want.shape == (11, D, D, D)
    np.testing.assert_array_equal(got[3:], want[3:])
    np.testing.assert_allclose(got[:3], want[:3], atol=1e-5)
    assert len(np.unique(want[3:].argmax(0))) > 1  # a real class mix reaches the solver


def test_material_ply(slice_runs):
    from pixie_tpu.utils.io import read_ply

    jply = slice_runs["jax"][2]
    tply = slice_runs["torch"][1]
    want, got = read_ply(jply)["vertex"], read_ply(tply)["vertex"]
    assert len(got) == len(want) == int(slice_runs["mask"].sum())
    np.testing.assert_array_equal(got["material_id"], want["material_id"])
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("density", "E", "nu", "conf"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_boundary_conditions_and_info(slice_runs):
    jdir, _, _, jinfo = slice_runs["jax"]
    tdir, _, tinfo = slice_runs["torch"]
    want = json.loads((jdir / "sim" / "boundary_conditions.json").read_text())
    got = json.loads((tdir / "sim" / "boundary_conditions.json").read_text())
    assert got == want
    for k in ("n_particles", "frames", "substeps_per_frame", "active_materials"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["final_state_finite"]
    assert (tdir / "sim" / "sim_info.json").exists()


def test_frame_positions(slice_runs):
    from pixie_tpu.utils.io import read_ply

    jdir = slice_runs["jax"][0] / "sim" / "ply_files"
    tdir = slice_runs["torch"][0] / "sim" / "ply_files"
    jframes = sorted(p.name for p in jdir.glob("frame_*.ply"))
    assert jframes == sorted(p.name for p in tdir.glob("frame_*.ply"))
    assert len(jframes) == 3
    moved = 0.0
    for name in jframes:
        want, got = read_ply(jdir / name)["vertex"], read_ply(tdir / name)["vertex"]
        pw = np.stack([want[k] for k in "xyz"], -1)
        pg = np.stack([got[k] for k in "xyz"], -1)
        assert np.isfinite(pg).all()
        np.testing.assert_allclose(pg, pw, atol=2e-5, err_msg=name)
        np.testing.assert_array_equal(got["material_id"], want["material_id"])
        moved = max(moved, float(np.abs(pw - np.stack(
            [read_ply(jdir / jframes[0])["vertex"][k] for k in "xyz"], -1)).max()))
    assert moved > 1e-4  # the rollout did something


def test_main_cli_runs_the_slice(tmp_path):
    """``main(argv)`` with pipeline.py's overrides, on CPU: both stages and
    their artifacts at the config tree's paths (one frame of 400 substeps)."""
    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.utils.io import read_ply

    kw = dict(cond_dim=32, model_channels=16, num_res_blocks=1, channel_mult=(1, 2),
              attention_resolutions=())
    _, mask, _, _, _ = _make_object(tmp_path, kw)
    pipeline.main([f"obj_id={OBJ}", f"paths.base_path={tmp_path}",
                   f"paths.physgaussian_config_dir={REPO / 'config'}",
                   f"training.default_grid_size={D}",
                   f"training.features.clip.feature_channels={FC}",
                   "training.training.unet_model_channels=16",
                   "training.training.unet_num_res_blocks=1",
                   "training.training.unet_channel_mult=[1,2]",
                   "physics.n_frames=1", "physics.debug=true"], device="cpu")
    ply = tmp_path / "render_outputs" / OBJ / "sample_0" / "mapped_preds.ply"
    assert len(read_ply(ply)["vertex"]) == int(mask.sum())
    sim = tmp_path / "mpm_sim_outputs" / "neural" / OBJ / "sample_0"
    info = json.loads((sim / "sim_info.json").read_text())
    assert info["frames"] == 1 and info["substeps_per_frame"] == 400
    assert info["final_state_finite"]
    assert (sim / "ply_files" / "frame_0000.ply").exists()
    assert (sim / "boundary_conditions.json").exists()


def test_latest_checkpoint_picks_a_loadable_pth(tmp_path):
    """A directory holding reference ``epoch_k.pth`` files and JAX orbax
    ``epoch_k`` directories: the port picks the highest ``.pth``, which
    ``load_params`` reads; JAX's trainer picks the highest orbax directory."""
    from pixie_tpu.train.trainer import latest_checkpoint as j_latest
    from pixie_tpu_torch.pipeline import latest_checkpoint
    from pixie_tpu_torch.train.inference import load_params

    for k in (3, 7):
        torch.save({"model_state_dict": {"w": torch.full((2,), float(k))}},
                   tmp_path / f"epoch_{k}.pth")
    for name in ("epoch_12", "epoch_20", "epoch_99.pth.d"):
        (tmp_path / name).mkdir()
    (tmp_path / "epoch_x.pth").write_bytes(b"")
    (tmp_path / "epoch_50.pth").mkdir()   # a directory, not a checkpoint file
    got = latest_checkpoint(tmp_path)
    assert got == tmp_path / "epoch_7.pth"
    assert float(load_params(got)["w"][0]) == 7.0
    assert j_latest(tmp_path) == tmp_path / "epoch_20"
    assert latest_checkpoint(tmp_path / "missing") is None
    empty = tmp_path / "orbax_only"
    (empty / "epoch_4").mkdir(parents=True)
    assert latest_checkpoint(empty) is None
