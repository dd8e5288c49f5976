"""The port's CLIP part segmentation (voxel/segmentation.py) and similarity
heatmaps (voxel/viz_segmentation.py) against the JAX package's, on the same
seeded voxel files, on the CPU."""

import numpy as np
import pytest
from PIL import Image

from pixie_tpu.voxel import segmentation as jseg
from pixie_tpu.voxel import viz_segmentation as jviz
from pixie_tpu_torch.voxel import segmentation as tseg
from pixie_tpu_torch.voxel import viz_segmentation as tviz

C = 24
PARTS = {
    "pot": {"density": 400.0, "E": 2e8, "nu": 0.4, "material_id": "stationary"},
    "trunk": {"density": 400.0, "E": 2e6, "nu": 0.4, "material_id": 1},
    "leaves": {"density": 200.0, "E": 2e4, "nu": 0.35, "material_id": 0},
}


def write_grid(root, d: int = 12, c: int = C, seed: int = 0, noise: float = 0.6):
    """A seeded clip_features artifact set: a ball mask, three sectors whose
    features carry one of three seeded query directions plus noise (so a
    few voxels flip label), float16 as the voxelizer writes them.  Returns
    (npz path, the query embeddings)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(3, c)).astype(np.float32)
    ijk = np.stack(np.meshgrid(*[np.arange(d)] * 3, indexing="ij"), -1)
    centred = (ijk + 0.5) / d - 0.5
    mask = (np.linalg.norm(centred, axis=-1) < 0.45).astype(np.float32)
    sector = np.digitize(np.arctan2(centred[..., 1], centred[..., 0]), [-np.pi / 3, np.pi / 3])
    feats = q[sector] + noise * rng.normal(size=(d, d, d, c))
    feats = np.where(mask[..., None] > 0, feats, 0.0).astype(np.float16)
    root.mkdir(parents=True, exist_ok=True)
    base = root / "clip_features"
    np.save(f"{base}_features.npy", feats)
    np.save(f"{base}_mask.npy", mask)
    np.savez(f"{base}.npz", min_bounds=np.full(3, -0.5, np.float32),
             max_bounds=np.full(3, 0.5, np.float32), grid_shape=np.array([d, d, d]),
             voxel_size=np.float32(1.0 / d))
    return f"{base}.npz", q


def test_run_clip_similarity_matches_jax():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(700, C)).astype(np.float32)
    f[3] = 0.0                               # a zero row: the 1e-8 floor
    q = rng.normal(size=(5, C)).astype(np.float32)
    jp, js = jseg.run_clip_similarity(f, q)
    tp, ts = tseg.run_clip_similarity(f, q, device="cpu")
    assert tp.dtype == ts.dtype == np.float32 and tp.shape == (700, 5)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    # float16 rows given as a tensor are widened as the npy's are
    import torch

    f16 = f.astype(np.float16)
    np.testing.assert_allclose(tseg.run_clip_similarity(torch.as_tensor(f16), q)[1],
                               jseg.run_clip_similarity(f16.astype(np.float32), q)[1],
                               rtol=0, atol=1e-5)


def test_clip_part_segmentation_matches_jax(tmp_path):
    npz, q = write_grid(tmp_path)
    jc, jl, js, jm = jseg.clip_part_segmentation(npz, list(PARTS), query_embs=q)
    tc, tl, ts, tm = tseg.clip_part_segmentation(npz, list(PARTS), query_embs=q, device="cpu")
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    assert tm == jm
    assert len(np.unique(tl)) == 3


@pytest.mark.parametrize("noise", [0.6, 2.0], ids=["few_flips", "many_flips"])
def test_knn_vote_matches_jax_on_a_lattice(tmp_path, noise):
    """k=200 on ~2,300 lattice voxels, where many neighbours tie at the
    k-th distance.  A voxel whose vote differs is shown; at most 0.1 % may."""
    npz, q = write_grid(tmp_path, d=18, noise=noise)
    coords, labels, _, _ = jseg.clip_part_segmentation(npz, list(PARTS), query_embs=q)
    assert len(coords) > 2000
    want = jseg.local_post_process_segmentation(coords, labels, k=200)
    got = tseg.local_post_process_segmentation(coords, labels, k=200, device="cpu")
    assert got.dtype == want.dtype
    bad = np.flatnonzero(got != want)
    assert len(bad) <= 0.001 * len(coords), (
        f"{len(bad)} of {len(coords)} votes differ at {coords[bad][:10]}: "
        f"ours {got[bad][:10]}, JAX {want[bad][:10]}")
    assert (want != labels).any()             # the vote did smooth something


def test_knn_vote_small_cases_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(size=(150, 3)).astype(np.float32)
    lab = rng.integers(0, 4, 150)
    for k in (1, 5, 200):                     # k clamped to n
        np.testing.assert_array_equal(
            tseg.local_post_process_segmentation(pts, lab, k=k, chunk=64, device="cpu"),
            jseg.local_post_process_segmentation(pts, lab, k=k, chunk=64))


def test_connected_component_cleanup_identical():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 0.2, size=(200, 3))
    b = rng.uniform(0.6, 0.8, size=(60, 3))
    coords = np.concatenate([a, b]).astype(np.float32)
    labels = np.concatenate([rng.integers(0, 2, 200), np.zeros(60, np.int64)])
    np.testing.assert_array_equal(tseg.connected_component_cleanup(coords, labels, 0.05),
                                  jseg.connected_component_cleanup(coords, labels, 0.05))
    empty = np.zeros((0, 3), np.float32)
    assert len(tseg.connected_component_cleanup(empty, np.zeros(0, np.int64))) == 0


def _files(d):
    return sorted(p.name for p in d.iterdir())


def test_save_segmented_point_cloud_bytes_identical(tmp_path):
    npz, q = write_grid(tmp_path / "grid")
    coords, labels, scores, _ = jseg.clip_part_segmentation(npz, list(PARTS), query_embs=q)
    jseg.save_segmented_point_cloud(coords, labels, scores, PARTS, list(PARTS),
                                    tmp_path / "jax", npz)
    tseg.save_segmented_point_cloud(coords, labels, scores, PARTS, list(PARTS),
                                    tmp_path / "torch", npz)
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "torch") == [
        "E_grid.npy", "density_grid.npy", "material_grid.npy", "material_id_grid.npy",
        "nu_grid.npy", "segmented_semantics.ply"]
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "torch" / n).read_bytes(), n


def assert_ply_matches(got_path, want_path):
    """Every vertex field bitwise, apart from ``conf``, the winning softmax
    probability: torch's product and exp differ from XLA's in the last bits,
    so it is held within 1e-5, as the scores are."""
    from pixie_tpu_torch.utils.io import read_ply

    got, want = read_ply(got_path)["vertex"], read_ply(want_path)["vertex"]
    assert got.dtype == want.dtype and len(got) == len(want)
    for name in want.dtype.names:
        if name == "conf":
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_generate_material_segmentation_identical(tmp_path):
    npz, q = write_grid(tmp_path / "grid", seed=4)
    results = {"material_dict": PARTS}
    for smooth in (False, True):
        j = jseg.generate_material_segmentation(npz, results, tmp_path / f"j{smooth}",
                                                query_embs=q, use_spatial_smoothing=smooth)
        t = tseg.generate_material_segmentation(npz, results, tmp_path / f"t{smooth}",
                                                query_embs=q, use_spatial_smoothing=smooth,
                                                device="cpu")
        assert t["metrics"] == j["metrics"]
        assert open(t["material_grid"], "rb").read() == open(j["material_grid"], "rb").read()
        assert_ply_matches(t["ply"], j["ply"])
    grid = np.load(tmp_path / "tFalse" / "material_grid.npy")
    assert set(np.unique(grid[..., 3])) == {0.0, 1.0, 6.0, 7.0}


def test_heatmaps_within_one_level(tmp_path):
    npz, q = write_grid(tmp_path / "grid", seed=5)
    queries = list(PARTS)
    jp = jviz.visualize_part_segmentation(npz, queries, tmp_path / "jax", query_embs=q, res=64)
    tp = tviz.visualize_part_segmentation(npz, queries, tmp_path / "torch", query_embs=q,
                                          res=64, device="cpu")
    assert [p.split("/")[-1] for p in tp] == [p.split("/")[-1] for p in jp]
    for a, b in zip(tp, jp):
        ia = np.asarray(Image.open(a), np.int16)
        ib = np.asarray(Image.open(b), np.int16)
        assert ia.shape == ib.shape == (64, 64, 3)
        assert np.abs(ia - ib).max() <= 1
        assert (ia != 255).any()
