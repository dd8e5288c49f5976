"""The U-Net data path and batch inference, port vs JAX package, on the CPU:
MaterialVoxelDataset (items, batches, validation), the split and its JSON,
compute_normalization_ranges, run_inference with its reports, and the
pipeline's neural stage on its file path (no device grid).

Objects follow the dataset's file contract, made by
tests/test_training.py:12 ``make_fixture_dataset`` (grid 8, 12 features);
the U-Nets are ``SMALL`` with seeded weights saved as the reference's
``epoch_0.pth``, which the JAX package reads through its own ``load_params``
(``convert_torch.load_torch_checkpoint`` given SMALL's depth and mults).

Tolerances:
  * dataset items, batches, the split, the split JSON, the three ranges
    files, the placeholder material grid, _gt.npy, _mask.npy, _info.json:
    bit for bit;
  * run_inference (JAX runs its lane-packed joint net, the port the two
    nets): class channels identical; continuous channels within the U-Net
    forward's atol 2e-4 / rtol 1e-3 (tests/test_torch_unet.py); seg_acc
    identical; the MSE metrics within 1e-3 absolute (differences of
    predictions within 2e-4 in squares of terms below 2); the material
    PLY's density, E and nu rtol 1e-2 (E is 10^(3.9 x the continuous
    channel)), its positions and ids identical.
"""

import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets the torch thread count)
from test_training import make_fixture_dataset
from unet_train_parity import SMALL, SMALL_KW, seeded_params

from pixie_tpu.train import data as JD
from pixie_tpu.train import inspect_ranges as JR
from pixie_tpu.utils.norm import REFERENCE_RANGES as J_RANGES
from pixie_tpu_torch.train import data as TD
from pixie_tpu_torch.train import inspect_ranges as TR
from pixie_tpu_torch.utils.norm import REFERENCE_RANGES

REPO = Path(__file__).resolve().parent.parent
D, FC = SMALL["grid_size"], SMALL["feature_channels"]
ARCH = dict(num_res_blocks=SMALL["num_res_blocks"], channel_mult=SMALL["channel_mult"])


def _datasets(root, **kw):
    kw = dict(grid_size=D, feature_channels=FC, **kw)
    return TD.MaterialVoxelDataset(root, REFERENCE_RANGES, **kw), \
        JD.MaterialVoxelDataset(root, J_RANGES, **kw)


def _assert_same(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# -- the dataset ------------------------------------------------------------------------

def test_items_and_batches_bit_identical(tmp_path):
    root = make_fixture_dataset(tmp_path / "ro", n_objects=5)
    tds, jds = _datasets(root)
    assert len(tds) == len(jds) == 5
    assert tds.samples == [TD.Sample(**vars(s)) for s in jds.samples]
    for i in range(5):
        for a, b in zip(tds[i], jds[i]):
            _assert_same(a, b)
    order = [4, 0, 3, 1, 2]
    for kw in (dict(), dict(drop_remainder=True), dict(pad_to_batch=True)):
        got, want = list(tds.batches(2, order, **kw)), list(jds.batches(2, order, **kw))
        assert len(got) == len(want) == (2 if kw.get("drop_remainder") else 3)
        for gb, wb in zip(got, want):
            for a, b in zip(gb, wb):
                _assert_same(a, b)
    assert list(tds.batches(2, order, pad_to_batch=True))[-1][0].shape[0] == 2


def test_items_as_stored_cast_to_the_same_values(tmp_path):
    """``feature_dtype=None`` (train_loop's read) leaves float16 features as
    stored; their float32 cast is the item JAX's dataset returns."""
    root = make_fixture_dataset(tmp_path / "ro", n_objects=2)
    for f in root.glob("*/clip_features_features.npy"):
        np.save(f, np.load(f).astype(np.float16))
    tds, jds = _datasets(root)
    raw = tds.item(1, feature_dtype=None)
    assert raw[0].dtype == np.float16
    for a, b in zip((raw[0].astype(np.float32),) + raw[1:], jds[1]):
        _assert_same(a, b)
    got = next(tds.batches(2, feature_dtype=None))
    want = next(jds.batches(2))
    assert got[0].dtype == np.float16
    for a, b in zip((got[0].astype(np.float32),) + got[1:], want):
        _assert_same(a, b)


def test_split_and_split_json_bit_identical(tmp_path):
    root = make_fixture_dataset(tmp_path / "ro", n_objects=5)
    tds, jds = _datasets(root)
    for n in (1, 5, 10, 37):
        assert TD.train_test_split(n) == JD.train_test_split(n)
        assert TD.train_test_split(n, 0.8, seed=3) == JD.train_test_split(n, 0.8, seed=3)
    tr, te = TD.train_test_split(len(tds))
    TD.save_splits(tmp_path / "t" / "s.json", tds, tr, te)
    JD.save_splits(tmp_path / "j" / "s.json", jds, tr, te)
    assert (tmp_path / "t" / "s.json").read_bytes() == (tmp_path / "j" / "s.json").read_bytes()
    assert TD.load_splits(tmp_path / "t" / "s.json") == JD.load_splits(tmp_path / "j" / "s.json")


def _corrupt(root: Path, case: str):
    obj = root / "obj000"
    if case == "ids":    # tests/test_training.py:56-67
        mat = np.load(obj / "sample_0" / "material_grid.npy")
        mat[..., -1] = 99
        np.save(obj / "sample_0" / "material_grid.npy", mat)
    elif case == "shape":
        np.save(obj / "clip_features_features.npy", np.zeros((D, D, D, FC + 1), np.float32))
    elif case == "missing":
        (obj / "sample_0" / "material_grid.npy").unlink()
    elif case == "unreadable":
        (obj / "sample_0" / "material_grid.npy").write_bytes(b"not an npy")


@pytest.mark.parametrize("case", ["ids", "shape", "missing", "unreadable", "blacklist",
                                  "classes"])
def test_validation_skips_the_same_objects(tmp_path, case):
    root = make_fixture_dataset(tmp_path / "ro", n_objects=3)
    _corrupt(root, case)
    kw = {}
    if case == "blacklist":
        (tmp_path / "bad.json").write_text(json.dumps(["obj001"]))
        kw["problematic_objects_path"] = tmp_path / "bad.json"
    if case == "classes":
        kw.update(target_obj_classes={"even"},
                  obj_class_lookup=lambda o: "even" if int(o[-1]) % 2 == 0 else "odd")
    tds, jds = _datasets(root, **kw)
    assert [s.obj_id for s in tds.samples] == [s.obj_id for s in jds.samples]
    assert len(tds) == 2


@pytest.mark.parametrize("feature_type", ["rgb", "occupancy"])
def test_other_feature_types(tmp_path, feature_type):
    root = make_fixture_dataset(tmp_path / "ro", n_objects=2)
    rng = np.random.default_rng(1)
    for obj in sorted(root.iterdir()):
        if feature_type == "rgb":
            np.save(obj / "clip_features_rgb.npy", rng.uniform(size=(D, D, D, 3)).astype(
                np.float32))
        else:
            np.save(obj / "sample_0" / "mask.npy", np.load(obj / "clip_features_mask.npy"))
    fc = 3 if feature_type == "rgb" else 1
    kw = dict(grid_size=D, feature_channels=fc, feature_type=feature_type)
    tds = TD.MaterialVoxelDataset(root, REFERENCE_RANGES, **kw)
    jds = JD.MaterialVoxelDataset(root, J_RANGES, **kw)
    assert len(tds) == len(jds) == 2
    for a, b in zip(tds[1], jds[1]):
        _assert_same(a, b)
    assert tds[1][0].shape == (D, D, D, fc)
    with pytest.raises(ValueError, match="Invalid feature type"):
        TD.MaterialVoxelDataset(root, REFERENCE_RANGES, feature_type="depth")


def test_mask_consistency_asserted_as_jax(tmp_path):
    root = make_fixture_dataset(tmp_path / "ro", n_objects=1)
    mask = np.load(root / "obj000" / "clip_features_mask.npy")
    mask[0, 0, 0] = 1.0 - mask[0, 0, 0]
    np.save(root / "obj000" / "clip_features_mask.npy", mask)
    tds, jds = _datasets(root)
    for ds in (tds, jds):
        with pytest.raises(AssertionError, match="Mask inconsistency"):
            ds[0]
    tds, jds = _datasets(root, enforce_mask_consistency=False)
    for a, b in zip(tds[0], jds[0]):
        _assert_same(a, b)


# -- normalization ranges ----------------------------------------------------------------

def _ranges_objects(root: Path, n: int):
    make_fixture_dataset(root, n_objects=n)
    # an object with no foreground and one with a non-positive density
    for name, edit in (("empty", lambda m: m.__setitem__((Ellipsis, 3), 7)),
                       ("negative", lambda m: m.__setitem__((0, 0, 0, 0), -1.0))):
        obj = root / name / "sample_0"
        obj.mkdir(parents=True)
        mat = np.load(root / "obj000" / "sample_0" / "material_grid.npy")
        mat[0, 0, 0, 3] = 0
        edit(mat)
        np.save(obj / "material_grid.npy", mat)
    return root


def test_normalization_ranges_files_equal_jax(tmp_path):
    root = _ranges_objects(tmp_path / "ro", 3)
    got = TR.compute_normalization_ranges(root, tmp_path / "t", reservoir_cap=1500, workers=1)
    want = JR.compute_normalization_ranges(root, tmp_path / "j", reservoir_cap=1500, workers=1)
    assert got == want and sorted(want[1]) == ["empty", "negative"]
    for name in ("normalization_ranges.yaml", "material_statistics.json",
                 "problematic_objects.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    from pixie_tpu_torch.utils.norm import load_normalization_ranges

    r = load_normalization_ranges(tmp_path / "t" / "normalization_ranges.yaml")
    assert r.density_min == want[0]["density_p1"]


def test_normalization_ranges_pool_and_cli(tmp_path):
    """More than 8 grids go through the (spawned) worker pool; the CLI
    writes the same files."""
    root = _ranges_objects(tmp_path / "ro", 8)
    TR.compute_normalization_ranges(root, tmp_path / "pool", workers=2)
    JR.compute_normalization_ranges(root, tmp_path / "j", workers=1)
    subprocess.run([sys.executable, "-m", "pixie_tpu_torch.train.inspect_ranges",
                    "--render-outputs", str(root), "--output", str(tmp_path / "cli")],
                   cwd=REPO, check=True, capture_output=True, timeout=120)
    for name in ("normalization_ranges.yaml", "material_statistics.json",
                 "problematic_objects.json"):
        want = (tmp_path / "j" / name).read_bytes()
        assert (tmp_path / "pool" / name).read_bytes() == want
        assert (tmp_path / "cli" / name).read_bytes() == want


# -- run_inference and the pipeline's file path ------------------------------------------

def _checkpoints(root: Path):
    from pixie_tpu_torch.train.trainer import TrainConfig

    dirs = {}
    for i, mode in enumerate(("discrete", "continuous")):
        d = root / f"ck_{mode}"
        d.mkdir(parents=True)
        torch.save({"model_state_dict": seeded_params(TrainConfig(mode=mode, **SMALL), 20 + i)},
                   d / "epoch_0.pth")
        dirs[mode] = d
    return dirs


@pytest.fixture
def jax_pth(monkeypatch):
    """The JAX package's load_params reads the port's epoch_0.pth at SMALL's
    depth and mults."""
    import pixie_tpu.models.convert_torch as ct

    monkeypatch.setattr(ct, "load_torch_checkpoint",
                        functools.partial(ct.load_torch_checkpoint, **ARCH))
    return monkeypatch


def _lookup(obj_id):
    return "odd" if int(obj_id[-1]) % 2 else "even"


def _assert_pred_close(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert got.shape == want.shape == (11, D, D, D)
    np.testing.assert_array_equal(got[3:], want[3:])
    np.testing.assert_allclose(got[:3], want[:3], atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(got[3:].sum(0), 1.0)


def _assert_metrics_close(got: dict, want: dict):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            if k in ("seg_acc", "n", "n_objects"):
                assert json.dumps(got[k]) == json.dumps(want[k]), k
            else:
                _assert_metrics_close(got[k], want[k])
    else:
        assert got == pytest.approx(want, abs=1e-3)


def test_run_inference_matches_jax(tmp_path, jax_pth):
    from pixie_tpu.train.inference import run_inference as j_run
    from pixie_tpu_torch.train.inference import run_inference

    root = make_fixture_dataset(tmp_path / "ro", n_objects=3)
    ck = _checkpoints(tmp_path)
    tds, jds = _datasets(root)
    args = (ck["discrete"] / "epoch_0.pth", ck["continuous"] / "epoch_0.pth")
    kw = dict(batch_size=2, model_kwargs=SMALL_KW, obj_class_lookup=_lookup)
    got = run_inference(tds, *args, tmp_path / "t", device="cpu", **kw)
    want = j_run(jds, *args, tmp_path / "j", **kw)
    _assert_metrics_close(json.loads(json.dumps(got)), json.loads(json.dumps(want)))
    assert got["n_objects"] == 3
    assert set(got) == {"n_objects", "per_object", "seg_acc", "density_mse", "youngs_mse",
                        "poisson_mse", "cont_mse"}
    assert set(got["seg_acc"]) == {"mean", "se", "ci90_lo", "ci90_hi", "n"}
    for name in ("metrics.json", "per_class_metrics.json"):
        _assert_metrics_close(json.loads((tmp_path / "t" / name).read_text()),
                              json.loads((tmp_path / "j" / name).read_text()))
    assert (tmp_path / "t" / "evaluated_obj_ids.json").read_bytes() == \
        (tmp_path / "j" / "evaluated_obj_ids.json").read_bytes()
    assert sorted(json.loads((tmp_path / "t" / "per_class_metrics.json").read_text())) == \
        ["even", "odd"]
    for obj in ("obj000", "obj001", "obj002"):
        t, j = tmp_path / "t" / obj, tmp_path / "j" / obj
        _assert_pred_close(t / "sample_0_pred.npy", j / "sample_0_pred.npy")
        for name in ("sample_0_gt.npy", "sample_0_mask.npy", "sample_0_info.json"):
            assert (t / name).read_bytes() == (j / name).read_bytes(), name
    # an index subset, batch 4 padded (pad_to_batch): one object's artifacts
    run_inference(tds, *args, tmp_path / "sub", batch_size=4, indices=[2],
                  model_kwargs=SMALL_KW, device="cpu")
    assert json.loads((tmp_path / "sub" / "evaluated_obj_ids.json").read_text()) == ["obj002"]
    assert not (tmp_path / "sub" / "per_class_metrics.json").exists()
    _assert_pred_close(tmp_path / "sub" / "obj002" / "sample_0_pred.npy",
                       tmp_path / "j" / "obj002" / "sample_0_pred.npy")


def _fresh_tree(base: Path):
    """render_outputs with 2 labelled objects and 'fresh', which has
    features, mask and npz but no material grid (a new object)."""
    root = make_fixture_dataset(base / "render_outputs", n_objects=3)
    fresh = root / "fresh"
    shutil.copytree(root / "obj002", fresh)
    shutil.rmtree(fresh / "sample_0")
    shutil.rmtree(root / "obj002")
    np.savez(fresh / "clip_features.npz", min_bounds=np.full(3, -0.5, np.float32),
             max_bounds=np.full(3, 0.5, np.float32), grid_shape=np.array([D, D, D]))
    return fresh


def test_pipeline_file_path_matches_jax(tmp_path, jax_pth):
    """generate_neural_segmentation without a device grid against the JAX
    pipeline's file path (pipeline.py:262-317): the occupancy placeholder,
    the dataset item, run_inference's artifacts and mapped_preds.ply.  JAX's
    stage is given SMALL's widths and the .pth-reading latest_checkpoint."""
    import pipeline as jpipe

    import pixie_tpu.train.inference as ji
    import pixie_tpu.train.trainer as jt
    from pixie_tpu.config import compose
    from pixie_tpu.utils.paths import get_output_paths, resolve_paths
    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.utils.io import read_ply

    out = {}
    for side in ("jax", "torch"):
        base = tmp_path / side
        fresh = _fresh_tree(base)
        ck = _checkpoints(base)
        (base / "checkpoints_discrete").symlink_to(ck["discrete"])
        (base / "checkpoints_continuous_mse").symlink_to(ck["continuous"])
        cfg = resolve_paths(compose(overrides=[
            "obj_id=fresh", f"paths.base_path={base}", f"training.default_grid_size={D}",
            f"training.features.clip.feature_channels={FC}"]))
        paths = get_output_paths(cfg, "fresh")
        assert Path(paths["render_output"]) == fresh
        if side == "jax":
            jax_pth.setattr(jt, "latest_checkpoint", pipeline.latest_checkpoint)
            jax_pth.setattr(ji, "run_inference",
                            functools.partial(ji.run_inference, model_kwargs=SMALL_KW))
            ply = jpipe.generate_neural_segmentation(cfg, paths)
        else:
            ply = pipeline.generate_neural_segmentation(
                fresh, paths["neural_base_dir"], "fresh", cfg.paths.discrete_checkpoint_dir,
                cfg.paths.continuous_checkpoint_dir, grid_size=D, feature_channels=FC,
                model_kwargs=SMALL_KW, device="cpu",
                batch_size=cfg.training.inference.batch_size)
        out[side] = (fresh, Path(paths["neural_base_dir"]) / "fresh", Path(ply))

    (tf, tn, tply), (jf, jn, jply) = out["torch"], out["jax"]
    assert (tf / "sample_0" / "material_grid.npy").read_bytes() == \
        (jf / "sample_0" / "material_grid.npy").read_bytes()
    _assert_pred_close(tn / "sample_0_pred.npy", jn / "sample_0_pred.npy")
    for name in ("sample_0_gt.npy", "sample_0_mask.npy"):
        assert (tn / name).read_bytes() == (jn / name).read_bytes(), name
    assert json.loads((tn / "sample_0_info.json").read_text())["obj_id"] == "fresh"
    metrics = json.loads((tn.parent / "metrics.json").read_text())
    _assert_metrics_close(metrics, json.loads((jn.parent / "metrics.json").read_text()))
    assert metrics["n_objects"] == 1
    a, b = read_ply(tply)["vertex"], read_ply(jply)["vertex"]
    assert len(a) == len(b) == int(np.load(tf / "clip_features_mask.npy").sum()) > 0
    for k in a.dtype.names:
        if k in ("density", "E", "nu", "conf"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-2, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # an object that fails the dataset's validation raises as JAX's stage
    with pytest.raises(RuntimeError, match="failed dataset validation"):
        pipeline.generate_neural_segmentation(
            tf, tmp_path / "n2", "fresh", tmp_path / "torch" / "ck_discrete",
            tmp_path / "torch" / "ck_continuous", grid_size=D, feature_channels=FC + 4,
            model_kwargs=SMALL_KW, device="cpu", overwrite=True)
