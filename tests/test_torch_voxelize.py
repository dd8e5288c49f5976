"""The port's voxelizer (pixie_tpu_torch/voxel/voxelize.py) and its pipeline
stage against the JAX package's, on the CPU.

  * ``create_occupancy_mask`` bit for bit against JAX's on seeded 32^3 and
    64^3 scenes (a ball, isolated outliers that take the lattice kNN's brute
    fallback, a small floating cluster, a sparse trail, dark and transparent
    voxels), with the voxelizer's defaults and with a 10-NN cut and DBSCAN
    cores of 30 points, under which DBSCAN drops the floating cluster (with
    the defaults, a voxel whose 50-NN mean passes the cut is always a core
    point, so DBSCAN drops nothing the cut kept).  The lattice kNN means
    agree to 4 float32 ulps (JAX's fused dot sums the shells in another
    order), the cut is taken on the host in float32 numpy by both, and every
    mask bit agrees.
  * ``extract_feature_voxel_grid`` at 16^3 on a duck-typed numpy field and
    on FieldAdapters with converted params: features within one float16 ulp
    (the port's exp and MLP sums round float32's last bit otherwise than
    XLA's, which moves a float16 rounding now and then; near zero, two
    float32 ulps of the largest feature), alphas and rgb the same
    (identical on the numpy field, within one float16 ulp through the MLPs,
    for the same reason), mask identical.
  * the pipeline's handoff: the grid left on the device gives the same
    mapped_preds.ply as the npy.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import to_np

from pixie_tpu_torch.recon import field as tfield
from pixie_tpu_torch.recon import field_adapter as tfa
from pixie_tpu_torch.voxel import voxelize as tv

REPO = Path(__file__).resolve().parent.parent


def _scene(d, seed=0):
    """(voxel grid, alphas (D,D,D,1) fp16, rgb (D,D,D,3) fp16) of a seeded
    scene on the [-0.5, 0.5]^3 box."""
    rng = np.random.default_rng(seed)
    grid = tv.dense_voxel_grid((-0.5,) * 3, (0.5,) * 3, 1.0 / d)
    r = np.linalg.norm(grid, axis=-1)
    alpha = np.where(r < 0.3, rng.uniform(0.2, 1.0, r.shape), 0.0)
    alpha[rng.random(r.shape) < 0.15] = 0.005                 # holes under the threshold
    far = r > 0.42
    outliers = far & (rng.random(r.shape) < 3.0 / far.sum())
    alpha[outliers] = 0.6                                     # isolated: the kNN fallback
    c = d // 8
    alpha[c:c + 3, c:c + 3, d - c - 3:d - c] = 0.7            # a small floating cluster
    for k in range(5):                                        # a sparse trail: DBSCAN noise
        alpha[d - c - 2 * k, c, c] = 0.8
    rgb = rng.uniform(0.0, 1.0, grid.shape)
    rgb[rng.random(r.shape) < 0.05] = 0.01                    # dark: the gray filter
    return grid, alpha[..., None].astype(np.float16), rgb.astype(np.float16)


@pytest.mark.parametrize("d,kw", [(32, {}), (64, {}),
                                  (32, dict(nb_neighbors=10, min_cluster_pts=30))],
                         ids=["32", "64", "32-dbscan"])
def test_occupancy_mask_bit_identical_to_jax(d, kw):
    from pixie_tpu.voxel import voxelize as jv

    grid, alphas, rgb = _scene(d, seed=d)
    jt, tt = {}, {}
    want = jv.create_occupancy_mask(grid, alphas, rgb, voxel_size=1.0 / d, timings=jt, **kw)
    got = tv.create_occupancy_mask(grid, alphas, rgb, voxel_size=1.0 / d, timings=tt,
                                   device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert set(tt) == set(jt) == {"outlier_knn_s", "dbscan_s"}
    # the cut removes voxels in this scene, and DBSCAN with cores of 30
    a = alphas.reshape(-1).astype(np.float32)
    cand = (a > 0.01) & (rgb.reshape(-1, 3).astype(np.float32).mean(-1) > 0.05)
    idx = np.flatnonzero(cand)
    ijk = np.stack(np.unravel_index(idx, grid.shape[:-1]), 1)
    k = kw.get("nb_neighbors", 50)
    mean_d = tv.lattice_knn_mean_dist(ijk, grid.shape[:-1], 1.0 / d, k=k, device="cpu")
    jmean = jv.lattice_knn_mean_dist(ijk, grid.shape[:-1], 1.0 / d, k=k)
    np.testing.assert_array_max_ulp(mean_d, jmean, maxulp=4)
    stat = mean_d < mean_d.mean() + 4.0 * mean_d.std()
    assert 0 < (~stat).sum() and int(got.sum()) <= int(stat.sum()) < len(idx)
    if kw:
        assert int(got.sum()) < int(stat.sum())
    assert int(got.sum()) > 0.5 * int(cand.sum())


def test_lattice_knn_fallback_and_dbscan_match_jax_helpers():
    """The lattice kNN's brute fallback rows and the lattice DBSCAN against
    the JAX package's brute kNN and host FFT DBSCAN (itself sklearn's)."""
    from pixie_tpu.sim.material_field import knn_mean_dist
    from pixie_tpu.voxel import voxelize as jv

    rng = np.random.default_rng(1)
    shape, h = (40, 40, 40), 1.0 / 64
    occ = rng.random(shape) < 0.05
    occ[1, 1, 1] = True
    occ[2:5, 1, 1] = False
    ijk = np.argwhere(occ)
    pts = ijk.astype(np.float32) * h
    brute = knn_mean_dist(pts, pts, k=10, skip_self=True)
    lat = tv.lattice_knn_mean_dist(ijk, shape, h, k=10, r_max=4, device="cpu")
    np.testing.assert_allclose(lat, brute, rtol=2e-6, atol=2e-7)
    for eps, min_pts in ((5.0, 10), (2.0, 5)):
        np.testing.assert_array_equal(
            tv.lattice_nonnoise_mask_device(ijk, shape, eps, min_pts, device="cpu"),
            jv.lattice_nonnoise_mask(ijk, shape, r_lattice=eps, min_points=min_pts))
    assert tv.lattice_nonnoise_mask_device(np.zeros((0, 3), np.int64), shape, 5.0).shape == (0,)


class SphereField:
    """A numpy field: a dense sphere of radius 0.3 with graded density."""

    def __init__(self, feat_dim=16):
        self.feat_dim = feat_dim

    def query(self, points):
        r = np.linalg.norm(np.asarray(points), axis=-1)
        density = np.where(r < 0.3, 400.0 * (0.35 - r), 0.01)[:, None].astype(np.float32)
        feature = np.sin(np.asarray(points) @ np.arange(3 * self.feat_dim).reshape(
            3, self.feat_dim) * 0.7).astype(np.float32)
        return {"density": density, "feature": feature}

    def get_rgb(self, points):
        p = np.asarray(points)
        return (0.5 + 0.5 * np.tanh(4.0 * p)).astype(np.float32)


def _extract_both(jfield, tfield_, tmp_path, **kw):
    from pixie_tpu.voxel.voxelize import extract_feature_voxel_grid as jextract

    common = dict(voxel_size=1 / 16, batch_size=1024, expected_grid=None, nb_neighbors=10, **kw)
    jp = jextract(jfield, tmp_path / "jax" / "clip_features.npz", **common)
    tp = tv.extract_feature_voxel_grid(tfield_, tmp_path / "torch" / "clip_features.npz",
                                       device="cpu", **common)
    jp["wait"]()
    tp["wait"]()
    return jp, tp


def _assert_fp16_close(got, want, key):
    """Within one float16 ulp of the larger of the two values; near zero,
    where a float16 ulp is finer than the float32 rounding of the values the
    MLPs sum, within two float32 ulps of the largest |value| (2^-22 of it)."""
    g, w = got.astype(np.float32), want.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))).astype(np.float32)
    bad = np.abs(g - w) > ulp + 2.0 ** -22 * np.abs(w).max()
    assert not bad.any(), f"{key}: {int(bad.sum())} values off by more than a float16 ulp"


def _assert_artifacts(jp, tp, exact_alpha_rgb: bool):
    f16 = np.finfo(np.float16)
    for key in ("features", "alphas", "rgb"):
        want, got = np.load(jp[key]), np.load(tp[key])
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape, key
        if key == "features" or not exact_alpha_rgb:
            _assert_fp16_close(got, want, key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    np.testing.assert_array_equal(np.load(tp["mask"]), np.load(jp["mask"]))
    assert np.load(tp["mask"]).any() and not np.load(tp["mask"]).all()
    jz, tz = np.load(jp["npz"]), np.load(tp["npz"])
    assert set(jz.files) == set(tz.files)
    for k in jz.files:
        np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    # rows at or under the threshold are exact zeros, on disk and on the device
    feats = np.load(tp["features"])
    low = np.load(tp["alphas"])[..., 0].astype(np.float32) <= 0.01
    assert low.any() and not feats[low].any()
    np.testing.assert_array_equal(to_np(tp["features_dev"]), feats)
    assert tp["timings"]["sparse_rows"] == jp["timings"]["sparse_rows"] == float((~low).sum())
    for k in ("query_s", "alphas_rgb_fetch_s", "save_s", "outlier_knn_s", "dbscan_s",
              "fetch_bg_s", "save_feat_s"):
        assert k in tp["timings"], k
    from pixie_tpu_torch.utils.io import read_ply
    assert len(read_ply(tp["pc_ply"])["vertex"]) == int(np.load(tp["mask"]).sum())


def test_extract_on_a_numpy_field_matches_jax(tmp_path):
    """A duck-typed field: JAX's per-batch fallback loop against the port's."""
    jp, tp = _extract_both(SphereField(), SphereField(), tmp_path)
    _assert_artifacts(jp, tp, exact_alpha_rgb=True)


def _seeded_sd(module: torch.nn.Module, seed: int, density_bias: float | None = None) -> dict:
    """Seeded parameters of a port field: tables U(0, 1), weights N(0, 0.3),
    biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if k.endswith("table"):
            a = rng.uniform(0.0, 1.0, v.shape)
        else:
            a = rng.normal(size=v.shape) * (0.3 if k.endswith("weight") else 0.1)
        sd[k] = torch.as_tensor(a.astype(np.float32))
    if density_bias is not None:
        sd["density_mlp.out.bias"][0] = density_bias
    return sd


def _flax_tree(sd: dict) -> dict:
    """The inverse of ``state_dict_from_jax``: a port state dict as a flax
    variables tree of numpy arrays."""
    tree: dict = {}
    for k, v in sd.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        a = to_np(v)
        node["kernel" if leaf == "weight" else leaf] = a.T.copy() if leaf == "weight" else a
    return {"params": tree}


def test_extract_on_field_adapters_matches_jax(tmp_path):
    """FieldAdapters over one seeded NerfField + 32-wide FeatureField, the
    port's from its state dicts and JAX's from the same parameters as a
    flax tree (round trip through state_dict_from_jax checked)."""
    from pixie_tpu.recon.field_adapter import FieldAdapter

    # a density bias of -1 leaves about a fifth of the voxels under the
    # alpha threshold
    nsd = _seeded_sd(tfield.NerfField(), 20, density_bias=-1.0)
    fsd = _seeded_sd(tfield.FeatureField(feature_dim=32), 21)
    ntree, ftree = _flax_tree(nsd), _flax_tree(fsd)
    for sd, tree in ((nsd, ntree), (fsd, ftree)):
        back = tfield.state_dict_from_jax(tree)
        assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    jp, tp = _extract_both(FieldAdapter(ntree, ftree, feature_dim=32),
                           tfa.FieldAdapter(nsd, fsd, feature_dim=32, device="cpu"), tmp_path)
    _assert_artifacts(jp, tp, exact_alpha_rgb=False)


def test_drain_failure_raises_from_wait(tmp_path, monkeypatch):
    real_replace = tv.os.replace

    def boom(src, dst):
        if dst.endswith("_features.npy"):
            raise OSError("disk full (injected)")
        return real_replace(src, dst)

    monkeypatch.setattr(tv.os, "replace", boom)
    paths = tv.extract_feature_voxel_grid(SphereField(), tmp_path / "clip_features.npz",
                                          voxel_size=1 / 16, expected_grid=16,
                                          batch_size=1024, nb_neighbors=10, device="cpu")
    with pytest.raises(RuntimeError, match="drain failed"):
        paths["wait"]()
    assert not Path(paths["features"]).exists()
    with pytest.raises(ValueError, match="grid shape"):
        tv.extract_feature_voxel_grid(SphereField(), tmp_path / "x.npz", voxel_size=1 / 16,
                                      device="cpu")


def test_generate_voxels_handoff_matches_the_npy(tmp_path):
    """pipeline.generate_voxels from a field checkpoint, then
    generate_neural_segmentation on the grid it left on the device, gives
    the mapped_preds.ply that the same stage gives from the npy."""
    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.models.unet3d import RegressionUNet, SegmentationUNet, seeded_state_dict
    from pixie_tpu_torch.recon.train_field import save_field_checkpoint
    from pixie_tpu_torch.utils.io import read_ply

    d, fc = 16, 32
    kw = dict(cond_dim=32, model_channels=16, num_res_blocks=1, channel_mult=(1, 2))
    nerf_out = tmp_path / "f3rm"
    save_field_checkpoint(nerf_out, {
        "nerf": _seeded_sd(tfield.NerfField(), 30, density_bias=4.0),
        "feat": _seeded_sd(tfield.FeatureField(feature_dim=fc), 31)}, feature_dim=fc)
    for i, (name, model, scale) in enumerate((
            ("discrete", SegmentationUNet(num_classes=8, feature_channels=fc, grid_size=d, **kw),
             1.0),
            ("continuous", RegressionUNet(out_channels=3, feature_channels=fc, grid_size=d,
                                          **kw), 1e-3))):
        (tmp_path / name).mkdir()
        torch.save({"model_state_dict": seeded_state_dict(model, seed=5 + i, head_scale=scale)},
                   tmp_path / name / "epoch_0.pth")
    render = tmp_path / "render_outputs" / "obj"
    vox = pipeline.generate_voxels(nerf_out, render, grid_size=d, device="cpu")
    assert vox["features_dev"].shape == (d, d, d, fc)
    seg = dict(grid_size=d, feature_channels=fc, model_kwargs=kw, device="cpu")
    ply_dev = pipeline.generate_neural_segmentation(
        render, tmp_path / "neural_dev", "obj", tmp_path / "discrete", tmp_path / "continuous",
        features_dev=vox["features_dev"], **seg)
    moved = ply_dev.with_name("mapped_preds_dev.ply")
    ply_dev.rename(moved)
    pipeline.finish_voxel_fetch(vox)
    assert "wait" not in vox
    ply_npy = pipeline.generate_neural_segmentation(
        render, tmp_path / "neural_npy", "obj", tmp_path / "discrete", tmp_path / "continuous",
        **seg)
    a, b = read_ply(moved)["vertex"], read_ply(ply_npy)["vertex"]
    assert len(a) == int(np.load(render / "clip_features_mask.npy").sum()) > 0
    for k in a.dtype.names:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert pipeline.generate_voxels(nerf_out, render, grid_size=d, device="cpu") is None
    meta = json.loads((nerf_out / "checkpoints" / "field_meta.json").read_text())
    assert meta["feature_dim"] == fc


def test_main_runs_the_voxelizer_from_a_field_checkpoint(tmp_path, monkeypatch):
    """``pipeline.main`` with a field checkpoint under the object's
    nerf_output: the voxelizer runs with the config's values (grid 16 by
    override, batch 4096), hands its device grid to the neural stage, and
    its feature npy is written before main returns.  The stages around it
    are recorded, not run."""
    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.config import compose
    from pixie_tpu_torch.recon.train_field import save_field_checkpoint
    from pixie_tpu_torch.utils.paths import get_output_paths, resolve_paths

    argv = ["obj_id=vox_obj", f"paths.base_path={tmp_path}", "voxelization.grid_size=16"]
    paths = get_output_paths(resolve_paths(compose(overrides=argv)), "vox_obj")
    save_field_checkpoint(paths["nerf_output"], {
        "nerf": _seeded_sd(tfield.NerfField(), 40, density_bias=4.0),
        "feat": _seeded_sd(tfield.FeatureField(feature_dim=32), 41)}, feature_dim=32)
    seen = {}
    monkeypatch.setattr(pipeline, "train_gaussians", lambda *a, **k: None)
    monkeypatch.setattr(pipeline, "generate_neural_segmentation",
                        lambda *a, **k: seen.update(seg=k) or Path(tmp_path / "m.ply"))
    monkeypatch.setattr(pipeline, "run_physics_simulation",
                        lambda ply, *a, **k: seen.update(sim=ply))
    pipeline.main(argv, device="cpu")
    art = pipeline.voxel_artifact_paths(paths["render_output"])
    feats = np.load(art["features"])
    assert feats.shape == (16, 16, 16, 32)
    np.testing.assert_array_equal(to_np(seen["seg"]["features_dev"]), feats)
    assert seen["sim"] == tmp_path / "m.ply" and Path(art["mask"]).exists()
