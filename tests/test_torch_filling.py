"""Internal particle filling and rollout checkpoint/resume, port vs JAX
package, on the CPU: the internal-cell mask, the densify and emission, the
filled positions, a GS-mode rollout of a filling config through both
drivers, resume against the uninterrupted rollout, and the rollout npz,
h5 and PLY formats read across the two packages.

Tolerances: masks, grids and filled positions identical (the densify and
the emission are the same numpy; the suffix scans count integers; the rng
is ``np.random.default_rng(seed)`` in both); resume bitwise (the CPU plain
path sums in a fixed order and the sim clock is saved as a float64); the
GS rollout as tests/test_torch_render.py holds it (uint8 frames within 1
LSB on at most 0.1 % of pixels, frame positions atol 2e-5).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import to_np

jnp = pytest.importorskip("jax.numpy")


def _shell_grids(n=16, r_out=6, r_in=4):
    """tests/test_filling.py's hollow sphere shell: (count, density)."""
    idx = np.arange(n) + 0.5
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    shell = (r <= r_out) & (r >= r_in)
    return shell.astype(np.int32), shell.astype(np.float32) * 10.0


def _open_box_grids(n=12):
    """tests/test_filling.py's box missing its +z face."""
    density = np.zeros((n, n, n), np.float32)
    density[3:9, 3:9, 3] = 10.0
    density[3, 3:9, 3:9] = 10.0
    density[8, 3:9, 3:9] = 10.0
    density[3:9, 3, 3:9] = 10.0
    density[3:9, 8, 3:9] = 10.0
    return (density > 0).astype(np.int32), density


def _random_grids(n=20, seed=0):
    """Seeded blobs: density of mixed sign and scale, counts 0..2."""
    rng = np.random.default_rng(seed)
    density = (rng.normal(size=(n, n, n)) * 3.0).astype(np.float32)
    count = rng.integers(0, 3, (n, n, n)).astype(np.int32) * (rng.random((n, n, n)) < 0.3)
    return count.astype(np.int32), density


SCENES = {"hollow_sphere": _shell_grids, "open_box": _open_box_grids, "random": _random_grids}


@pytest.mark.parametrize("dirs", [(5, 4), (2, 4), (0, 1), (3, 5), (4, 0), (1, 6)])
@pytest.mark.parametrize("scene", list(SCENES))
def test_internal_cells_mask_bit_identical(scene, dirs):
    from pixie_tpu.sim.filling import internal_cells_mask as j_mask
    from pixie_tpu_torch.sim.filling import internal_cells_mask as t_mask

    count, density = SCENES[scene]()
    want = np.asarray(j_mask(jnp.asarray(count), jnp.asarray(density), 1.0, *dirs))
    got = to_np(t_mask(count, density, 1.0, *dirs, device="cpu"))
    assert got.dtype == np.bool_ and got.shape == count.shape
    np.testing.assert_array_equal(got, want)
    if scene == "hollow_sphere" and dirs == (5, 4):
        assert got.sum() > 0   # the shell's interior is found


def _shell_gaussians(n=800, seed=0, radius=0.3, var=4e-4):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = (0.5 + radius * d).astype(np.float32)
    cov = np.tile(np.array([var, 0, 0, var, 0, var], np.float32), (n, 1))
    cov[:, 1] = rng.uniform(-0.3, 0.3, n).astype(np.float32) * var
    return pos, rng.uniform(0.3, 1.0, n).astype(np.float32), cov


def test_densify_grids_identical():
    from pixie_tpu.sim.filling import densify_grids as j_densify
    from pixie_tpu_torch.sim.filling import densify_grids as t_densify

    pos, op, cov = _shell_gaussians(300, seed=3)
    cov[:5] *= 40.0   # a few large gaussians: the stencil grows to r 3
    args = (pos, op, cov, 24, 1.0 / 24)
    for got, want in zip(t_densify(*args), j_densify(*args)):
        np.testing.assert_array_equal(got, want)


FILL_CASES = {
    "shell": dict(),
    "boundary": dict(boundary=[0.3, 0.7, 0.25, 0.75, 0.2, 0.8]),
    "budget_binds": dict(max_samples=900),
    "two_per_cell": dict(max_particles_per_cell=2, search_exclude_dir=2),
}


@pytest.mark.parametrize("case", list(FILL_CASES))
def test_fill_particles_identical_positions(case):
    from pixie_tpu.sim.filling import fill_particles as j_fill
    from pixie_tpu_torch.sim.filling import fill_particles as t_fill

    pos, op, cov = _shell_gaussians()
    kw = dict(grid_n=24, max_samples=5000, grid_dx=1.0 / 24, density_thres=0.5,
              search_thres=0.5, seed=11)
    kw.update(FILL_CASES[case])
    want = j_fill(pos, op, cov, **kw)
    got = t_fill(pos, op, cov, **kw, device="cpu")
    assert got.dtype == np.float32 and len(got) > 0
    np.testing.assert_array_equal(got, want)
    if case == "budget_binds":
        assert len(got) == 100


def test_init_filled_particles_matches_jax():
    from pixie_tpu.sim.filling import init_filled_particles as j_init
    from pixie_tpu_torch.sim.filling import init_filled_particles as t_init

    rng = np.random.default_rng(4)
    orig = rng.uniform(0.0, 1.0, (200, 3)).astype(np.float32)
    new = rng.uniform(0.0, 1.0, (50, 3)).astype(np.float32)
    attrs = {"opacity": rng.random((200, 1)).astype(np.float32),
             "shs": rng.normal(size=(200, 16, 3)).astype(np.float32)}
    want, got = j_init(new, orig, attrs), t_init(new, orig, attrs, device="cpu")
    for k in attrs:
        np.testing.assert_array_equal(got[k], want[k])
    empty = t_init(np.zeros((0, 3)), orig, attrs, device="cpu")
    assert empty["shs"].shape == (0, 16, 3)


# -- the GS path with filling, and resume ----------------------------------------

def _filling_scene(root: Path):
    """tests/test_torch_render.py's GS scene with its 300 gaussians on a
    sphere shell, and a config that fills them (n_grid 24, fill grid 32)."""
    from pixie_tpu.recon import gaussians as JG
    from test_torch_render import _gs_scene

    root = _gs_scene(root)
    rng = np.random.default_rng(2)
    d = rng.normal(size=(300, 3))
    pts = (0.2 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    params = JG.create_from_points(pts, colors=rng.uniform(0.2, 0.9, (300, 3)).astype(
        np.float32), initial_opacity=0.9)
    JG.save_gaussian_ply(root / "gs" / "point_cloud" / "iteration_50" / "point_cloud.ply", params)
    cfg = json.loads((root / "sim.json").read_text())
    cfg.update(frame_num=3, particle_filling={
        "n_grid": 32, "density_threshold": 0.5, "search_threshold": 0.5,
        "search_exclude_direction": 5, "ray_cast_direction": 4, "max_particles_num": 5000,
        "max_partciels_per_cell": 1, "boundary": [0.0, 2.0, 0.0, 2.0, 0.0, 2.0]})
    (root / "fill.json").write_text(json.dumps(cfg))
    return root


@pytest.fixture(scope="module")
def fill_runs(tmp_path_factory):
    from pixie_tpu.sim.driver import run_simulation as j_run
    from pixie_tpu_torch.sim.driver import run_simulation as t_run

    root = _filling_scene(tmp_path_factory.mktemp("fill_path"))
    kw = dict(gaussian_checkpoint=root / "gs", render_img=True, save_ply=True, debug=True)
    jinfo = j_run(root / "mapped_preds.ply", root / "fill.json", root / "jax",
                  use_fast_solver=False, **kw)
    tinfo = t_run(root / "mapped_preds.ply", root / "fill.json", root / "torch", device="cpu",
                  checkpoint_every=1, **kw)
    return root, jinfo, tinfo


def test_gs_filling_rollout_matches_jax(fill_runs):
    from PIL import Image

    from pixie_tpu.recon.gaussians import load_gaussian_ply as j_load
    from pixie_tpu_torch.recon.gaussians import load_gaussian_ply as t_load
    from test_torch_render import _assert_frames_close

    root, jinfo, tinfo = fill_runs
    assert tinfo["n_particles"] == jinfo["n_particles"] > 300   # filled particles were added
    assert tinfo["n_filled"] == tinfo["n_particles"] - 300
    for k in ("frames", "substeps_per_frame", "active_materials", "auto_bcs"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["final_state_finite"]
    for i in range(3):
        want = np.asarray(Image.open(root / "jax" / "frames" / f"{i:05d}.png"))
        got = np.asarray(Image.open(root / "torch" / "frames" / f"{i:05d}.png"))
        _assert_frames_close(got, want)
        name = f"frame_{i:05d}.ply"
        w = j_load(root / "jax" / "ply_files" / name)
        g = t_load(root / "torch" / "ply_files" / name)
        assert len(g["xyz"]) == 300   # the gaussians only: filled particles are not rendered
        np.testing.assert_allclose(to_np(g["xyz"]), np.asarray(w["xyz"]), atol=2e-5)


def test_resume_equals_the_uninterrupted_rollout(fill_runs, tmp_path):
    """checkpoint_every=1 to frame 1, then resume=True to frame 3: the frame
    files after the resume point and the final state equal the
    uninterrupted run's bit for bit."""
    from pixie_tpu_torch.sim.driver import run_simulation
    from pixie_tpu_torch.sim.engine_utils import load_rollout_checkpoint

    root, _, full = fill_runs
    out = tmp_path / "resumed"
    kw = dict(gaussian_checkpoint=root / "gs", render_img=True, save_ply=True, device="cpu",
              checkpoint_every=1)
    run_simulation(root / "mapped_preds.ply", root / "fill.json", out, n_frames=1, **kw)
    (out / "frames" / "00000.png").unlink()   # a resumed run does not redo frame 0
    info = run_simulation(root / "mapped_preds.ply", root / "fill.json", out, resume=True, **kw)
    assert info["n_particles"] == full["n_particles"] and len(info["frame_s"]) == 2
    assert not (out / "frames" / "00000.png").exists()
    for i in (1, 2):
        for rel in (f"frames/{i:05d}.png", f"ply_files/frame_{i:05d}.ply"):
            assert (out / rel).read_bytes() == (root / "torch" / rel).read_bytes(), rel
    got, t_got, f_got = load_rollout_checkpoint(out / "rollout_ckpt.npz", device="cpu")
    want, t_want, f_want = load_rollout_checkpoint(root / "torch" / "rollout_ckpt.npz",
                                                   device="cpu")
    assert (t_got, f_got) == (t_want, f_want) and f_got == 3
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


def test_resume_refuses_another_scene(fill_runs, tmp_path):
    from pixie_tpu_torch.sim.driver import run_simulation

    root, _, _ = fill_runs
    out = tmp_path / "other"
    out.mkdir()
    (out / "rollout_ckpt.npz").write_bytes((root / "torch" / "rollout_ckpt.npz").read_bytes())
    with pytest.raises(ValueError, match="particle count"):
        run_simulation(root / "mapped_preds.ply", root / "sim.json", out, n_frames=2,
                       gaussian_checkpoint=root / "gs", resume=True, device="cpu")


# -- formats read across the packages --------------------------------------------

def _state_pair(n=64, seed=0):
    from torch_parity import make_pair, random_particles

    rng = np.random.default_rng(seed)
    return make_pair(random_particles(n, seed),
                     material=rng.integers(0, 7, n).astype(np.int32),
                     selection=(np.arange(n) % 5 == 0).astype(np.int32),
                     cov=rng.normal(size=(n, 6)).astype(np.float32))


def test_rollout_npz_reads_both_ways(tmp_path):
    from pixie_tpu.sim import engine_utils as J
    from pixie_tpu_torch.sim import engine_utils as T

    js, ts = _state_pair()
    T.save_rollout_checkpoint(tmp_path / "t.npz", ts, 0.125, 7)
    J.save_rollout_checkpoint(tmp_path / "j.npz", js, 0.25, 9)
    j_from_t, jt, jf = J.load_rollout_checkpoint(tmp_path / "t.npz")
    t_from_j, tt, tf = T.load_rollout_checkpoint(tmp_path / "j.npz", device="cpu")
    assert (jt, jf, tt, tf) == (0.125, 7, 0.25, 9)
    for f in dataclasses.fields(ts):
        want_t, want_j = to_np(getattr(ts, f.name)), np.asarray(getattr(js, f.name))
        got_j, got_t = np.asarray(getattr(j_from_t, f.name)), to_np(getattr(t_from_j, f.name))
        assert got_j.dtype == want_t.dtype and got_t.dtype == want_j.dtype, f.name
        np.testing.assert_array_equal(got_j, want_t, err_msg=f.name)
        np.testing.assert_array_equal(got_t, want_j, err_msg=f.name)
    assert not list(tmp_path.glob("*.tmp.npz"))   # the atomic write left no temp file


def test_h5_and_position_ply_match_jax(tmp_path):
    from pixie_tpu.sim import engine_utils as J
    from pixie_tpu_torch.sim import engine_utils as T

    rng = np.random.default_rng(5)
    x = rng.uniform(0, 2, (40, 3)).astype(np.float32)
    vol = rng.uniform(1e-6, 1e-5, 40).astype(np.float32)
    T.save_particles_h5(tmp_path / "t" / "p.h5", x, vol)
    for got, want in zip(J.load_particles_h5(tmp_path / "t" / "p.h5"), (x, vol)):
        np.testing.assert_array_equal(got, want)
    J.save_particles_h5(tmp_path / "j.h5", x, vol)
    for got, want in zip(T.load_particles_h5(tmp_path / "j.h5"), (x, vol)):
        np.testing.assert_array_equal(got, want)
    colors = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    for c in (None, colors):
        T.save_positions_ply(tmp_path / "t.ply", x, c)
        J.save_positions_ply(tmp_path / "j.ply", x, c)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
