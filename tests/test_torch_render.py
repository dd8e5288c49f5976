"""The GS-rendered rollout, port vs JAX package, on the CPU: gaussian model
and PLY I/O, projection, the dense and tiled rasterizers (the port's plain
blend against JAX's ``blend_stream`` in interpret mode), ``SimRenderer``
and the whole GS-checkpoint path of ``run_simulation``.

Tolerances (float32 throughout):
  * covariance, SH, projection: atol 1e-5 / rtol 1e-5 (same formulas,
    rounding of different matmul orders);
  * PLY round trips: identical;
  * images: atol 2e-5 (the blend's exp/log1p in two libraries, over up to
    512 splats a pixel);
  * uint8 frames: at most 1 LSB, on at most 0.1 % of pixels (rounding at
    the .5 boundaries of img * 255 + 0.5);
  * world pos/cov atol 1e-5; frame PLY positions atol 2e-5 after 150
    substeps.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_parity import splat_scene, to_np

jnp = pytest.importorskip("jax.numpy")

REPO = Path(__file__).resolve().parent.parent
TIGHT = dict(atol=1e-5, rtol=1e-5)


def _gauss_params(n=200, seed=0, degree=3):
    """Random gaussians as numpy: unit-ish quats, log-scales, logits, SH."""
    rng = np.random.default_rng(seed)
    k = (degree + 1) ** 2
    return {
        "xyz": rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        "f_dc": rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        "f_rest": rng.normal(0, 0.2, (n, k - 1, 3)).astype(np.float32),
        "scaling": rng.uniform(np.log(0.01), np.log(0.08), (n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity": rng.uniform(-2.0, 3.0, (n, 1)).astype(np.float32),
    }


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in p.items()})


def _viewmat():
    # a tilted camera 2.2 units from the origin, looking at it
    from pixie_tpu_torch.sim.camera import look_at_viewmat

    return look_at_viewmat([0.9, -1.7, 1.1], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0])


# -- gaussians ----------------------------------------------------------------

def test_covariance_and_activations_match_jax():
    from pixie_tpu.recon import gaussians as JG
    from pixie_tpu_torch.recon import gaussians as TG

    jp, tp = _both(_gauss_params())
    np.testing.assert_allclose(to_np(TG.covariance_upper(tp, 1.3)),
                               np.asarray(JG.covariance_upper(jp, 1.3)), **TIGHT)
    for fn in ("get_scaling", "get_opacity", "get_rotation", "get_shs"):
        np.testing.assert_allclose(to_np(getattr(TG, fn)(tp)),
                                   np.asarray(getattr(JG, fn)(jp)), err_msg=fn, **TIGHT)
    q = TG.get_rotation(tp)
    np.testing.assert_allclose(to_np(TG.quat_to_rotmat(q)),
                               np.asarray(JG.quat_to_rotmat(jnp.asarray(to_np(q)))), **TIGHT)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    from pixie_tpu.recon import gaussians as JG
    from pixie_tpu_torch.recon import gaussians as TG

    rng = np.random.default_rng(degree)
    shs = rng.normal(size=(257, (degree + 1) ** 2, 3)).astype(np.float32)
    d = rng.normal(size=(257, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(
        to_np(TG.eval_sh(torch.as_tensor(shs), torch.as_tensor(d), degree)),
        np.asarray(JG.eval_sh(jnp.asarray(shs), jnp.asarray(d), degree)), **TIGHT)


def test_create_from_points_matches_jax():
    from pixie_tpu.recon import gaussians as JG
    from pixie_tpu_torch.recon import gaussians as TG

    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.3, 0.3, (150, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (150, 3)).astype(np.float32)
    want = JG.create_from_points(pts, colors=cols, initial_opacity=0.9)
    got = TG.create_from_points(pts, colors=cols, initial_opacity=0.9)
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), err_msg=k, **TIGHT)


def test_gaussian_ply_round_trips(tmp_path):
    """Port save -> port load, JAX save -> port load and port save -> JAX
    load all give back the same arrays (Inria layout, f_rest channel-major)."""
    from pixie_tpu.recon import gaussians as JG
    from pixie_tpu_torch.recon import gaussians as TG

    p = _gauss_params(n=37, seed=5)
    jp, tp = _both(p)
    TG.save_gaussian_ply(tmp_path / "port.ply", tp)
    JG.save_gaussian_ply(tmp_path / "jax.ply", jp)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    for loaded in (TG.load_gaussian_ply(tmp_path / "port.ply"),
                   TG.load_gaussian_ply(tmp_path / "jax.ply"),
                   JG.load_gaussian_ply(tmp_path / "port.ply")):
        for k, v in p.items():
            np.testing.assert_array_equal(to_np(loaded[k]), v, err_msg=k)


# -- projection and rasterizers -------------------------------------------------

@pytest.mark.parametrize("precomp", ["none", "cov6_colors_opacity", "cov3d"])
def test_project_gaussians_matches_jax(precomp):
    from pixie_tpu.recon import gaussians as JG
    from pixie_tpu.recon import rasterizer as JR
    from pixie_tpu_torch.recon import rasterizer as TR

    p = _gauss_params(n=300, seed=1)
    # behind the camera: culled by opacity, z clamped to 1e-4
    p["xyz"][:5] = 1.5 * np.array([0.9, -1.7, 1.1]) + p["xyz"][:5] * 0.5
    jp, _ = _both(p)
    if precomp == "cov6_colors_opacity":
        rng = np.random.default_rng(2)
        p = {"xyz": p["xyz"], "cov6_precomp": np.asarray(JG.covariance_upper(jp)),
             "colors_precomp": rng.uniform(0, 1, (300, 3)).astype(np.float32),
             "opacity_precomp": rng.uniform(0, 1, (300,)).astype(np.float32)}
    elif precomp == "cov3d":
        p["cov3d_precomp"] = np.asarray(JG.get_covariance(jp))
    jp, tp = _both(p)
    vm = _viewmat()
    cam = (1.0, 96, 80, 70.0, 75.0, 40.0, 47.0)
    want = JR.project_gaussians(jp, jnp.asarray(vm), JR.Camera(*cam[1:]), cam[0])
    got = TR.project_gaussians(tp, torch.as_tensor(vm), TR.Camera(*cam[1:]), cam[0])
    # rows 5: only; behind the camera, x / 1e-4 amplifies the rounding of x
    for name, g, w in zip(("means2d", "cov2d", "depth", "rgb", "opacity"), got, want):
        np.testing.assert_allclose(to_np(g)[5:], np.asarray(w)[5:], err_msg=name, **TIGHT)
    assert float(to_np(got[2])[:5].max()) < 0.0
    assert float(to_np(got[4])[:5].max()) == 0.0 == float(np.asarray(want[4])[:5].max())


def _raster_scene(n=300, seed=0, scale=0.03):
    """tests/test_gaussians.py's tiled-rasterizer scene (64x64, camera at z=-2)."""
    rng = np.random.default_rng(seed)
    p = {"xyz": rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)}
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    p["f_dc"] = ((cols - 0.5) / 0.28209479177387814)[:, None, :].astype(np.float32)
    p["f_rest"] = np.zeros((n, 15, 3), np.float32)
    p["scaling"] = np.full((n, 3), np.log(scale), np.float32)
    p["rotation"] = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    p["opacity"] = rng.uniform(-1.0, 2.0, (n, 1)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 2.0
    return p, vm


@pytest.mark.parametrize("case", ["default", "tile_cap_binds", "max_tiles_side_binds"])
def test_rasterize_tiled_matches_jax(case):
    """Port tiled rasterizer (plain blend) vs JAX's (blend_stream, interpret
    mode), atol 2e-5; the two truncation cases must actually bind."""
    from pixie_tpu.recon import rasterizer as JR
    from pixie_tpu_torch.recon import rasterizer as TR

    n, scale, kw = {"default": (300, 0.03, dict(tile_cap=512, max_tiles_side=6)),
                    "tile_cap_binds": (600, 0.03, dict(tile_cap=128, max_tiles_side=6)),
                    "max_tiles_side_binds": (300, 0.12, dict(tile_cap=512, max_tiles_side=2)),
                    }[case]
    p, vm = _raster_scene(n=n, scale=scale)
    jp, tp = _both(p)
    cam = (64, 64, 64.0, 64.0, 32.0, 32.0)
    want_img, want_a = JR.rasterize_tiled(jp, jnp.asarray(vm), JR.Camera(*cam), bg_color=0.25,
                                          **kw)
    got_img, got_a = TR.rasterize_tiled(tp, torch.as_tensor(vm), TR.Camera(*cam),
                                        bg_color=0.25, **kw)
    np.testing.assert_allclose(to_np(got_img), np.asarray(want_img), atol=2e-5)
    np.testing.assert_allclose(to_np(got_a), np.asarray(want_a), atol=2e-5)

    bins = TR.bin_tiles(tp, torch.as_tensor(vm), TR.Camera(*cam), **kw)
    assert not TR.jax_stream_overflows(bins)  # JAX renders every tile here
    dense, _ = TR.rasterize(tp, torch.as_tensor(vm), TR.Camera(*cam), bg_color=0.25)
    truncated = float((to_np(got_img) - to_np(dense)).__abs__().max())
    if case == "tile_cap_binds":
        assert int((bins.raw > kw["tile_cap"]).sum()) > 0 and truncated > 1e-3
    elif case == "max_tiles_side_binds":
        assert truncated > 1e-3 and int(bins.raw.max()) <= kw["tile_cap"]
    else:
        assert truncated < 2e-5


def test_rasterize_dense_matches_jax():
    from pixie_tpu.recon import rasterizer as JR
    from pixie_tpu_torch.recon import rasterizer as TR

    p, vm = _raster_scene(n=200, seed=3)
    jp, tp = _both(p)
    cam = (48, 64, 60.0, 60.0, 32.0, 24.0)
    want = JR.rasterize(jp, jnp.asarray(vm), JR.Camera(*cam), bg_color=1.0)
    got = TR.rasterize(tp, torch.as_tensor(vm), TR.Camera(*cam), bg_color=1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=2e-5)


def test_blend_plain_empty_and_transparent_tiles():
    """Tiles with no entries, or only entries below alpha 1/255, keep T = 1
    and show the background; a single opaque splat at a pixel centre gives
    alpha 0.99 there."""
    from pixie_tpu_torch.ops import gs_stream

    feat = torch.tensor([[8.5, 8.5, 1.0, 0.0, 1.0, 0.2, 0.4, 0.6, 1.0],    # opaque
                         [40.5, 8.5, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.003]])  # < 1/255
    idx = torch.tensor([0, 1], dtype=torch.int32)
    starts = torch.tensor([0, 1, 2], dtype=torch.int32)
    counts = torch.tensor([1, 1, 0], dtype=torch.int32)
    img, trans = gs_stream.blend_plain(feat, idx, starts, counts, tx_n=3, bg=0.5)
    assert img.shape == (16, 48, 3) and trans.shape == (16, 48)
    np.testing.assert_allclose(to_np(trans[8, 8]), 0.01, rtol=1e-5)  # exp(log1p(-0.99))
    np.testing.assert_allclose(to_np(img[8, 8]), 0.99 * np.array([0.2, 0.4, 0.6]) + 0.005,
                               rtol=1e-5)
    assert float(trans[:, 16:].min()) == 1.0
    np.testing.assert_array_equal(to_np(img[:, 16:]), 0.5)


def _plain_gate(feat, px, py):
    """gs_stream's gate per (gaussian, pixel): alpha >= 1/255, op by op."""
    from pixie_tpu_torch.ops import gs_stream

    dx, dy = px - feat[:, 0], py - feat[:, 1]
    power = -0.5 * (feat[:, 2] * dx * dx + feat[:, 4] * dy * dy) - feat[:, 3] * dx * dy
    alpha = torch.clamp(feat[:, 8] * torch.exp(torch.clamp(power, max=0.0)),
                        max=gs_stream.ALPHA_MAX)
    return alpha >= gs_stream.ALPHA_MIN


def _inside(box, px, py):
    return (box[:, 0] <= px) & (px <= box[:, 1]) & (box[:, 2] <= py) & (py <= box[:, 3])


def _box_case(sx, sy, rho, op, angle, n=256, seed=0):
    """Gaussians of screen std sx, sy and correlation rho (+0.3 on the
    covariance's diagonal, as the projection), with conics as _conic makes
    them, and pixels at 0.9 to 1.1 of the exact 1/255 ellipse's radius."""
    from pixie_tpu_torch.recon import rasterizer as TR

    rng = np.random.default_rng(seed)
    cxy = rho * sx * sy
    cov = torch.tensor([[sx * sx + 0.3, cxy, sy * sy + 0.3]] * n, dtype=torch.float32)
    conic, _ = TR._conic(cov)
    mx = torch.as_tensor(rng.uniform(0.0, 800.0, n).astype(np.float32))
    my = torch.as_tensor(rng.uniform(0.0, 800.0, n).astype(np.float32))
    feat = torch.cat([mx[:, None], my[:, None], conic, torch.full((n, 3), 0.5),
                      torch.full((n, 1), op)], 1)
    th = angle + rng.uniform(0.0, 2.0 * np.pi, n)
    d = np.stack([np.cos(th), np.sin(th)], 1)
    c = conic.double().numpy()
    q = c[:, 0] * d[:, 0] ** 2 + 2 * c[:, 1] * d[:, 0] * d[:, 1] + c[:, 2] * d[:, 1] ** 2
    rad = np.sqrt(2.0 * max(np.log(255.0 * op), 0.0) / q) * rng.uniform(0.9, 1.1, n)
    px = torch.as_tensor((mx.double().numpy() + rad * d[:, 0]).astype(np.float32))
    py = torch.as_tensor((my.double().numpy() + rad * d[:, 1]).astype(np.float32))
    return feat, px, py


@settings(max_examples=200, deadline=None, database=None)
@given(sx=st.floats(0.05, 400.0), sy=st.floats(0.05, 400.0), rho=st.floats(-0.9999, 0.9999),
       op=st.one_of(st.floats(1e-4, 1.0), st.floats(1.0, 50.0)), angle=st.floats(0.0, 6.3),
       seed=st.integers(0, 2**16))
def test_blend_box_never_drops_a_pair_the_gate_keeps(sx, sy, rho, op, angle, seed):
    """The box of csrc/gs_stream.cu:blend_box (its plain version), from which
    each warp of the blend kernel builds its entry list, holds every pixel at
    which the plain gate alpha >= 1/255 passes: pixels drawn around the
    exact ellipse of the gate, for any screen std, any correlation up to
    0.9999 (where the box becomes the whole plane) and opacities from below
    1/255 (an empty box: the gate never passes) to 50."""
    from pixie_tpu_torch.ops import gs_stream

    feat, px, py = _box_case(sx, sy, rho, op, angle, seed=seed)
    keep = _plain_gate(feat, px, py)
    box = gs_stream.blend_box_plain(feat)
    assert bool((_inside(box, px, py) | ~keep).all())
    if op < gs_stream.ALPHA_MIN:
        assert not bool(keep.any()) and bool((box[:, 0] > box[:, 1]).all())


def test_blend_box_holds_every_kept_pair_of_a_scene():
    """Every (tile entry, pixel) pair of a binned scene whose plain gate
    passes lies in the entry's box; the boxes are tight enough to drop most
    (warp rows, entry) pairs, and degenerate conics (non-positive, NaN, a
    correlation of 1) get the whole plane."""
    from pixie_tpu_torch.ops import gs_stream
    from pixie_tpu_torch.recon import rasterizer as TR

    p, vm = splat_scene(400, seed=6)
    bins = TR.bin_tiles({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(vm),
                        TR.Camera(64, 64, 64.0, 64.0, 32.0, 32.0), tile_cap=256)
    box = gs_stream.blend_box_plain(bins.feat)
    px, py = gs_stream._pixel_centres(bins.starts.shape[0], bins.tx_n, "cpu")
    kept = met = pairs = 0
    for t in range(bins.starts.shape[0]):
        g = bins.idx[int(bins.starts[t]):int(bins.starts[t]) + int(bins.counts[t])].long()
        f, b = bins.feat[g][:, None], box[g][:, None]
        x, y = px[t][None, :], py[t][None, :]
        keep = _plain_gate(f.expand(-1, 256, -1).reshape(-1, 9), x.expand(len(g), -1).reshape(-1),
                           y.expand(len(g), -1).reshape(-1)).reshape(len(g), 256)
        inside = (b[..., 0] <= x) & (x <= b[..., 1]) & (b[..., 2] <= y) & (y <= b[..., 3])
        assert bool((inside | ~keep).all())
        # a warp's pixels: 8 x 4 blocks of the 16 x 16 tile
        rows = inside.reshape(len(g), 4, 4, 2, 8).any(-1).any(-2).reshape(len(g), 8)
        kept, met, pairs = kept + int(keep.sum()), met + int(rows.sum()), pairs + rows.numel()
    assert kept > 0 and met < 0.8 * pairs
    odd = torch.tensor([[5.0, 5.0, -1.0, 0.0, 1.0, 0, 0, 0, 0.5],
                        [5.0, 5.0, 1.0, float("nan"), 1.0, 0, 0, 0, 0.5],
                        [5.0, 5.0, 1.0, 1.0, 1.0, 0, 0, 0, 0.5]])
    assert torch.equal(gs_stream.blend_box_plain(odd).abs(), torch.full((3, 4), float("inf")))


def test_rasterize_tiled_raises_off_the_stream_branch():
    """Off the stream branch: tile_cap 1280 is JAX's slot-table branch (B5)
    and now runs through the same blend, matching JAX's image (atol 2e-5);
    tile_cap 100 (not a multiple of chunk) raises where JAX raises; tile 8
    with the blend kernels asked for raises (they take 16x16 tiles; JAX's
    B5 call would misshape them), while tile 8 by default runs JAX's XLA
    scan (test_rasterize_tiled_scan_branch_matches_jax)."""
    from pixie_tpu.recon import rasterizer as JR
    from pixie_tpu_torch.recon import rasterizer as TR

    p, vm = _raster_scene(n=300, seed=2)
    jp, tp = _both(p)
    cam = (64, 64, 64.0, 64.0, 32.0, 32.0)
    want = JR.rasterize_tiled(jp, jnp.asarray(vm), JR.Camera(*cam), bg_color=0.25, tile_cap=1280)
    got = TR.rasterize_tiled(tp, torch.as_tensor(vm), TR.Camera(*cam), bg_color=0.25,
                             tile_cap=1280)
    assert TR.slot_table_chunk(1280, 128) == 256    # the carry-grown chunk of JAX's B5 call
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=2e-5)
    assert float(to_np(got[1]).max()) > 0.5
    small = TR.Camera(32, 32, 32.0, 32.0, 16.0, 16.0)
    with pytest.raises(AssertionError):
        JR.rasterize_tiled(jp, jnp.asarray(vm), JR.Camera(32, 32, 32.0, 32.0, 16.0, 16.0),
                           tile_cap=100)
    with pytest.raises(ValueError, match="multiple of chunk"):
        TR.rasterize_tiled(tp, torch.as_tensor(vm), small, tile_cap=100)
    with pytest.raises(ValueError, match="carry-grown"):    # JAX's ValueError (:518-522)
        TR.rasterize_tiled(tp, torch.as_tensor(vm), small, tile_cap=1408)
    with pytest.raises(NotImplementedError):
        TR.rasterize_tiled(tp, torch.as_tensor(vm), small, tile=8, use_pallas_blend=True)
    with pytest.raises(ValueError, match="multiple of chunk"):
        TR.rasterize_tiled(tp, torch.as_tensor(vm), small, tile=8, tile_cap=100)


SCAN_CASES = {"tile_8": dict(tile=8), "tile_16_no_kernel": dict(use_pallas_blend=False),
              "tile_8_chunk_64": dict(tile=8, tile_cap=256, chunk=64, max_tiles_side=4)}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_rasterize_tiled_scan_branch_matches_jax(case):
    """JAX's XLA-scan branch (tile != 16, or use_pallas_blend=False): the
    port's plain scan against JAX's, image and alpha to 2e-5, and the
    gradients of every param key and mean2d_offset against jax.grad (rtol
    1e-4, atol 1e-5 of the key's largest |grad|, as tests/test_torch_train.py)."""
    import jax

    from pixie_tpu.recon import rasterizer as JR
    from pixie_tpu_torch.recon import rasterizer as TR

    kw = SCAN_CASES[case]
    p, vm = splat_scene(300, seed=4)
    n, cam = 300, (64, 64, 64.0, 64.0, 32.0, 32.0)
    rng = np.random.default_rng(9)
    wi = rng.normal(size=(64, 64, 3)).astype(np.float32)
    wa = rng.normal(size=(64, 64)).astype(np.float32)

    def jloss(jp, off):
        img, a = JR.rasterize_tiled(jp, jnp.asarray(vm), JR.Camera(*cam), bg_color=0.25,
                                    mean2d_offset=off, **kw)
        return jnp.sum(img * wi) + jnp.sum(a * wa), (img, a)

    (_, (want_img, want_a)), (jg, jo) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.zeros((n, 2), jnp.float32))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    to = torch.zeros((n, 2), requires_grad=True)
    img, a = TR.rasterize_tiled(tp, torch.as_tensor(vm), TR.Camera(*cam), bg_color=0.25,
                                mean2d_offset=to, **kw)
    np.testing.assert_allclose(to_np(img), np.asarray(want_img), atol=2e-5)
    np.testing.assert_allclose(to_np(a), np.asarray(want_a), atol=2e-5)
    assert float(to_np(a).max()) > 0.5
    (torch.sum(img * torch.as_tensor(wi)) + torch.sum(a * torch.as_tensor(wa))).backward()
    want = {**{k: np.asarray(v) for k, v in jg.items()}, "mean2d_offset": np.asarray(jo)}
    got = {**{k: to_np(v.grad) for k, v in tp.items()}, "mean2d_offset": to_np(to.grad)}
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_stream_cap_blanks_the_same_tiles_as_jax():
    """An explicit stream_cap of 6 chunks: JAX's stream renders every tile
    past the budget empty, and so does the port (the tiles' counts are 0):
    the same tiles show the background exactly in both, and the images agree
    to 2e-5; without the budget the port renders them."""
    from pixie_tpu.recon import rasterizer as JR
    from pixie_tpu_torch.recon import rasterizer as TR

    p, vm = _raster_scene(n=300, seed=0)
    jp, tp = _both(p)
    cam, kw = (64, 64, 64.0, 64.0, 32.0, 32.0), dict(tile_cap=256, stream_cap=6 * 128)
    want_img, want_a = JR.rasterize_tiled(jp, jnp.asarray(vm), JR.Camera(*cam), bg_color=0.25,
                                          **kw)
    got_img, got_a = TR.rasterize_tiled(tp, torch.as_tensor(vm), TR.Camera(*cam),
                                        bg_color=0.25, **kw)
    np.testing.assert_allclose(to_np(got_img), np.asarray(want_img), atol=2e-5)
    np.testing.assert_allclose(to_np(got_a), np.asarray(want_a), atol=2e-5)
    bins = TR.bin_tiles(tp, torch.as_tensor(vm), TR.Camera(*cam), tile_cap=256,
                        stream_cap=6 * 128)
    assert TR.jax_stream_overflows(bins)
    blank = to_np(((bins.counts == 0) & (bins.raw > 0)).reshape(4, 4))
    assert 0 < blank.sum() < 16
    tiles_a = [np.asarray(x).reshape(4, 16, 4, 16).transpose(0, 2, 1, 3) for x in (want_a, got_a)]
    for t in tiles_a:
        assert float(np.abs(t[blank]).max()) == 0.0 and float(t[~blank].max()) > 0.1
    full, _ = TR.rasterize_tiled(tp, torch.as_tensor(vm), TR.Camera(*cam), bg_color=0.25,
                                 tile_cap=256, stream_cap=None)
    assert float((full - got_img).abs().max()) > 0.1
    unbudgeted = TR.bin_tiles(tp, torch.as_tensor(vm), TR.Camera(*cam), tile_cap=256)
    assert not TR.jax_stream_overflows(unbudgeted)


# -- render_sim and the camera ---------------------------------------------------

def _gs_scene(root: Path):
    """tests/test_render_sim.py's GS scene (300 gaussians of a jelly block),
    with a cameras.json at 96x88 (not a multiple of 16: pad and crop) so the
    frames stay small; the config's default_camera_index 1 selects it."""
    from pixie_tpu.recon import gaussians as JG
    from pixie_tpu.utils.io import make_material_vertex, write_ply
    from pixie_tpu_torch.sim.camera import look_at_viewmat

    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.2, 0.2, (300, 3)).astype(np.float32)
    params = JG.create_from_points(pts, colors=rng.uniform(0.2, 0.9, (300, 3)).astype(
        np.float32), initial_opacity=0.9)
    params["f_rest"] = jnp.asarray(rng.normal(0, 0.1, (300, 15, 3)).astype(np.float32))
    ckpt = root / "gs" / "point_cloud" / "iteration_50"
    ckpt.mkdir(parents=True)
    JG.save_gaussian_ply(ckpt / "point_cloud.ply", params)
    cams = []
    for i, eye in enumerate(([1.2, 0.3, 0.4], [0.7, -0.9, 0.5])):
        vm = look_at_viewmat(eye, [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]).astype(np.float64)
        c2w = np.linalg.inv(vm)
        cams.append({"id": i, "width": 96, "height": 88, "fx": 110.0, "fy": 105.0,
                     "position": c2w[:3, 3].tolist(), "rotation": c2w[:3, :3].tolist()})
    (root / "gs" / "cameras.json").write_text(json.dumps(cams))
    write_ply(root / "mapped_preds.ply", make_material_vertex(
        coords=pts, density=np.full(300, 400.0, np.float32),
        E=np.full(300, 2e5, np.float32), nu=np.full(300, 0.3, np.float32),
        material_id=np.zeros(300, np.int64)))
    cfg = {"material": "jelly", "n_grid": 24, "grid_lim": 2.0, "substep_dt": 1e-4,
           "frame_dt": 5e-3, "frame_num": 3, "g": 9.8,
           "mpm_space_viewpoint_center": [1.0, 1.0, 1.0],
           "mpm_space_vertical_upward_axis": [0, 0, 1], "default_camera_index": 1,
           "init_azimuthm": 30.0, "init_elevation": 20.0, "init_radius": 1.5}
    (root / "sim.json").write_text(json.dumps(cfg))
    return root


def _assert_frames_close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("camera_index", [1, -1])
def test_sim_camera_sequence_matches_jax(tmp_path, camera_index):
    from pixie_tpu.sim import camera as JC
    from pixie_tpu_torch.sim import camera as TC

    root = _gs_scene(tmp_path)
    cfg = json.loads((root / "sim.json").read_text())
    cfg.update(default_camera_index=camera_index, move_camera=True, delta_a=2.0)
    rot = [np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)]
    outs = []
    for mod in (JC, TC):
        center, obs = mod.get_center_view_worldspace_and_observant_coordinate(
            cfg["mpm_space_viewpoint_center"], cfg["mpm_space_vertical_upward_axis"],
            rot, 2.3, np.array([0.1, -0.2, 0.3]))
        outs.append(mod.get_sim_camera_sequence(cfg, root / "gs", center, obs, 3))
    (jv, *jrest), (tv, *trest) = outs
    assert trest == jrest
    np.testing.assert_array_equal(np.stack(tv), np.stack(jv))


def _renderers(root: Path):
    """(JAX SimRenderer, port SimRenderer, x_mpm, cov6_mpm) for the scene,
    set up as the drivers do, with a sim_area crop so static splats render."""
    from pixie_tpu.recon import gaussians as JG
    from pixie_tpu.sim import render_sim as JS
    from pixie_tpu.sim import transforms as tf
    from pixie_tpu_torch.sim import render_sim as TS

    gs = JG.load_gaussian_ply(root / "gs" / "point_cloud" / "iteration_50" / "point_cloud.ply")
    pos = np.asarray(gs["xyz"])
    cov = np.asarray(JG.covariance_upper(gs))
    shs, op = np.asarray(JG.get_shs(gs)), np.asarray(JG.get_opacity(gs))
    rot = tf.generate_rotation_matrices([30.0], [2])
    m = tf.apply_rotations(pos, rot)[:, 2] < 0.12                  # the crop
    unselected = {"pos": pos[~m], "cov6": cov[~m], "opacity": op[~m], "shs": shs[~m]}
    pos_norm, scale, mean = tf.transform2origin(tf.apply_rotations(pos[m], rot))
    x_mpm = tf.shift2center111(pos_norm, 0.1)
    cov_mpm = (tf.apply_cov_rotations(cov[m], rot) * scale ** 2).astype(np.float32)
    cam = json.loads((root / "sim.json").read_text())
    kw = dict(camera_params=cam, model_path=root / "gs", n_frames=2, shs=shs[m],
              opacity_act=op[m], scale_origin=scale, original_mean_pos=mean,
              rotation_matrices=rot, z_shift=0.1, unselected=unselected, white_bg=True)
    return (JS.SimRenderer.from_camera_params(**kw),
            TS.SimRenderer.from_camera_params(**kw, device="cpu"),
            x_mpm, cov_mpm)


def test_sim_renderer_defaults_to_the_card():
    """SimRenderer defaults to CUDA, as every other entry point of the port
    does; the CPU is asked for explicitly, as these tests do."""
    import dataclasses
    import inspect

    from pixie_tpu_torch.sim.render_sim import SimRenderer

    sig = inspect.signature(SimRenderer.from_camera_params)
    assert sig.parameters["device"].default == "cuda"
    fields = {f.name: f for f in dataclasses.fields(SimRenderer)}
    assert fields["device"].default == torch.device("cuda")


def test_render_frame_matches_jax(tmp_path):
    jr, tr, x_mpm, cov_mpm = _renderers(_gs_scene(tmp_path))
    want, (jpos, jcov) = jr.render_frame(1, x_mpm, cov_mpm)
    got, (tpos, tcov) = tr.render_frame(1, torch.as_tensor(x_mpm), torch.as_tensor(cov_mpm))
    assert got.shape == (88, 96, 3)
    _assert_frames_close(got, want)
    assert (want < 250).mean() > 0.05  # splats cover part of the white frame
    np.testing.assert_allclose(to_np(tpos), np.asarray(jpos), atol=1e-5)
    np.testing.assert_allclose(to_np(tcov), np.asarray(jcov), atol=1e-5)
    np.testing.assert_allclose(to_np(tpos), jr.to_world(x_mpm), atol=1e-5)
    np.testing.assert_allclose(tr.cov_to_world(cov_mpm), jr.cov_to_world(cov_mpm), atol=1e-9)


def test_frame_ply_export_matches_jax(tmp_path):
    from pixie_tpu.sim.render_sim import cov6_to_log_scales_quats as j_decomp
    from pixie_tpu_torch.sim.render_sim import cov6_to_log_scales_quats as t_decomp

    jr, tr, x_mpm, cov_mpm = _renderers(_gs_scene(tmp_path))
    cov_w = jr.cov_to_world(cov_mpm)
    for a, b in zip(t_decomp(cov_w), j_decomp(cov_w)):
        np.testing.assert_array_equal(a, b)
    pos_w = jr.to_world(x_mpm).astype(np.float32)
    jr.export_gaussian_ply(tmp_path / "j.ply", pos_w, cov_w)
    tr.export_gaussian_ply(tmp_path / "t.ply", pos_w, torch.as_tensor(cov_w))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_png_writer_decodes_to_the_same_array(tmp_path):
    from PIL import Image

    from pixie_tpu_torch.sim.render_sim import save_frame_png

    img = np.random.default_rng(0).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    save_frame_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)
    save_frame_png(tmp_path / "b.png", img.astype(np.float32) / 255.0)
    decoded = np.asarray(Image.open(tmp_path / "b.png")).astype(np.int32)
    assert np.abs(decoded - img).max() <= 1


def test_checkpoint_lookup_and_volumes_match_jax(tmp_path):
    from pixie_tpu.recon.train_gaussians import search_for_max_iteration as j_search
    from pixie_tpu.sim.filling import get_particle_volume as j_vol
    from pixie_tpu_torch.recon.train_gaussians import search_for_max_iteration as t_search
    from pixie_tpu_torch.sim.filling import get_particle_volume as t_vol

    for name in ("iteration_100", "iteration_7000", "iteration_x", "other"):
        (tmp_path / name).mkdir()
    assert t_search(tmp_path) == j_search(tmp_path) == 7000
    assert t_search(tmp_path / "other") == -1
    pos = np.random.default_rng(0).uniform(0.5, 1.5, (500, 3)).astype(np.float32)
    for uniform in (False, True):
        np.testing.assert_array_equal(t_vol(pos, 24, 2.0 / 24, uniform),
                                      j_vol(pos, 24, 2.0 / 24, uniform))


# -- the whole GS path ------------------------------------------------------------

@pytest.fixture(scope="module")
def gs_runs(tmp_path_factory):
    from pixie_tpu.sim.driver import run_simulation as j_run
    from pixie_tpu_torch.sim.driver import run_simulation as t_run

    root = _gs_scene(tmp_path_factory.mktemp("gs_path"))
    kw = dict(gaussian_checkpoint=root / "gs", render_img=True, save_ply=True, debug=True)
    jinfo = j_run(root / "mapped_preds.ply", root / "sim.json", root / "jax",
                  use_fast_solver=False, **kw)
    tinfo = t_run(root / "mapped_preds.ply", root / "sim.json", root / "torch",
                  device="cpu", **kw)
    return root, jinfo, tinfo


def test_gs_path_frames_match_jax(gs_runs):
    from PIL import Image

    root, _, _ = gs_runs
    names = sorted(p.name for p in (root / "jax" / "frames").glob("*.png"))
    assert names == ["00000.png", "00001.png", "00002.png"]
    assert sorted(p.name for p in (root / "torch" / "frames").glob("*.png")) == names
    for name in names:
        want = np.asarray(Image.open(root / "jax" / "frames" / name))
        got = np.asarray(Image.open(root / "torch" / "frames" / name))
        _assert_frames_close(got, want)
        assert got.mean() > 1.0  # splats on the black background


def test_gs_path_plys_match_jax(gs_runs):
    from pixie_tpu.recon.gaussians import load_gaussian_ply as j_load
    from pixie_tpu_torch.recon.gaussians import load_gaussian_ply as t_load

    root, _, _ = gs_runs
    names = sorted(p.name for p in (root / "jax" / "ply_files").glob("*.ply"))
    assert names == [f"frame_{i:05d}.ply" for i in range(3)]
    moved = 0.0
    for name in names:
        want = j_load(root / "jax" / "ply_files" / name)
        got = t_load(root / "torch" / "ply_files" / name)
        np.testing.assert_allclose(to_np(got["xyz"]), np.asarray(want["xyz"]), atol=2e-5)
        for k in ("f_dc", "f_rest", "opacity"):
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)
        assert all(torch.isfinite(v).all() for v in got.values())
        moved = max(moved, float(np.abs(np.asarray(want["xyz"]) - np.asarray(
            j_load(root / "jax" / "ply_files" / names[0])["xyz"])).max()))
    assert moved > 1e-4  # gravity moved the splats


def test_gs_path_info_and_bcs_match_jax(gs_runs):
    root, jinfo, tinfo = gs_runs
    assert set(jinfo) <= set(tinfo)
    for k in ("n_particles", "frames", "substeps_per_frame", "active_materials", "auto_bcs"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["median_render_ms"] is not None and tinfo["final_state_finite"]
    assert json.loads((root / "torch" / "sim_info.json").read_text())["n_particles"] == 300
    assert (json.loads((root / "torch" / "boundary_conditions.json").read_text())
            == json.loads((root / "jax" / "boundary_conditions.json").read_text()))


def test_gs_path_mixed_materials_match_jax(tmp_path, monkeypatch):
    """A material PLY of its own vertices with mixed ids, densities, E and nu,
    under a rotation and a sim_area crop: the kNN mapping of the whole PLY
    onto the gaussians gives both drivers the same per-particle material,
    density, E and nu (ids exact, floats rtol 1e-6) and the same BCs."""
    from pixie_tpu.sim.driver import run_simulation as j_run
    from pixie_tpu.sim.solver import MPMSolver as JSolver
    from pixie_tpu.utils.io import make_material_vertex, write_ply
    from pixie_tpu_torch.sim.driver import run_simulation as t_run
    from pixie_tpu_torch.sim.solver import MPMSolver as TSolver

    root = _gs_scene(tmp_path)
    rng = np.random.default_rng(7)
    verts = rng.uniform(-0.22, 0.22, (400, 3)).astype(np.float32)
    write_ply(root / "mixed.ply", make_material_vertex(
        coords=verts, density=rng.uniform(200.0, 2000.0, 400).astype(np.float32),
        E=(10.0 ** rng.uniform(4.0, 6.0, 400)).astype(np.float32),
        nu=rng.uniform(0.2, 0.4, 400).astype(np.float32),
        material_id=np.array([0, 1, 2, 5])[2 * (verts[:, 0] > 0) + (verts[:, 1] > 0)]))
    cfg = json.loads((root / "sim.json").read_text())
    cfg.update(rotation_degree=[30.0], rotation_axis=[2], sim_area=[-1, 1, -1, 1, -1, 0.12])
    (root / "mixed.json").write_text(json.dumps(cfg))
    seen = {}
    for name, cls in (("jax", JSolver), ("torch", TSolver)):
        def record(self, density, E, nu, material_id, _orig=cls.set_per_particle_materials,
                   _name=name):
            seen[_name] = [np.asarray(a) for a in (material_id, density, E, nu)]
            return _orig(self, density, E, nu, material_id)
        monkeypatch.setattr(cls, "set_per_particle_materials", record)
    kw = dict(n_frames=1, save_ply=False, gaussian_checkpoint=root / "gs")
    jinfo = j_run(root / "mixed.ply", root / "mixed.json", root / "jax",
                  use_fast_solver=False, **kw)
    tinfo = t_run(root / "mixed.ply", root / "mixed.json", root / "torch", device="cpu", **kw)
    assert 0 < tinfo["n_particles"] == jinfo["n_particles"] < 300  # the crop binds
    assert tinfo["active_materials"] == jinfo["active_materials"] == [0, 1, 2, 5]
    assert tinfo["auto_bcs"] == jinfo["auto_bcs"]
    (t_mat, *t_vals), (j_mat, *j_vals) = seen["torch"], seen["jax"]
    np.testing.assert_array_equal(t_mat, j_mat)
    for t, j, k in zip(t_vals, j_vals, ("density", "E", "nu")):
        np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=k)
        assert np.ptp(t) > 0.1 * np.max(t), k  # the values really vary


def test_unported_options_raise(tmp_path):
    """Particle filling and checkpoint/resume, once unported, now run
    (tests/test_torch_filling.py holds them to JAX): a filling config of one
    key runs on decode_param_json's defaults, a resume without a checkpoint
    starts from frame 0, and render_img still needs a checkpoint."""
    from pixie_tpu_torch.sim.driver import run_simulation

    root = _gs_scene(tmp_path)
    cfg = json.loads((root / "sim.json").read_text())
    cfg["particle_filling"] = {"n_grid": 24}
    (root / "fill.json").write_text(json.dumps(cfg))
    info = run_simulation(root / "mapped_preds.ply", root / "fill.json", root / "o1",
                          n_frames=1, save_ply=False, gaussian_checkpoint=root / "gs",
                          device="cpu")
    assert info["n_filled"] == info["n_particles"] - 300 >= 0
    info = run_simulation(root / "mapped_preds.ply", root / "sim.json", root / "o2", n_frames=1,
                          save_ply=False, device="cpu", resume=True, checkpoint_every=1)
    assert len(info["frame_s"]) == 1 and (root / "o2" / "rollout_ckpt.npz").exists()
    with pytest.raises(ValueError, match="gaussian_checkpoint"):
        run_simulation(root / "mapped_preds.ply", root / "sim.json", root / "o3",
                       render_img=True, device="cpu")


def test_main_cli_renders_a_gs_checkpoint(tmp_path):
    """``pipeline.main`` finds the object's 3DGS checkpoint and, as
    pipeline.py does, simulates and renders its gaussians under the tree
    config (camera 4 of cameras.json), then compiles the frames (one frame
    of 400 substeps, on the CPU)."""
    from pixie_tpu.config import compose
    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.recon.gaussians import create_from_points, save_gaussian_ply
    from pixie_tpu_torch.sim.camera import look_at_viewmat
    from pixie_tpu_torch.utils.paths import get_output_paths, resolve_paths
    from test_torch_slice import D, FC, OBJ, _make_object

    _make_object(tmp_path, dict(cond_dim=32, model_channels=16, num_res_blocks=1,
                                channel_mult=(1, 2), attention_resolutions=()))
    argv = [f"obj_id={OBJ}", f"paths.base_path={tmp_path}",
            f"paths.physgaussian_config_dir={REPO / 'config'}",
            f"training.default_grid_size={D}", f"training.features.clip.feature_channels={FC}",
            "training.training.unet_model_channels=16", "training.training.unet_num_res_blocks=1",
            "training.training.unet_channel_mult=[1,2]", "physics.n_frames=1"]
    gs = Path(get_output_paths(resolve_paths(compose(overrides=argv)), OBJ)["gs_output"])
    rng = np.random.default_rng(0)
    d = rng.normal(size=(250, 3))
    pts = (0.3 * d / np.linalg.norm(d, axis=1, keepdims=True)
           * rng.uniform(size=(250, 1)) ** (1 / 3)).astype(np.float32)
    params = create_from_points(pts, colors=rng.uniform(0.2, 0.9, (250, 3)), initial_opacity=0.8)
    save_gaussian_ply(gs / "point_cloud" / "iteration_7000" / "point_cloud.ply", params)
    cams = []
    for i in range(5):
        c2w = np.linalg.inv(look_at_viewmat([2.0 * np.cos(i), 2.0 * np.sin(i), 0.5],
                                            [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]))
        cams.append({"id": i, "width": 64, "height": 64, "fx": 90.0, "fy": 90.0,
                     "position": c2w[:3, 3].tolist(), "rotation": c2w[:3, :3].tolist()})
    (gs / "cameras.json").write_text(json.dumps(cams))

    pipeline.main(argv, device="cpu")
    sim = tmp_path / "mpm_sim_outputs" / "neural" / OBJ / "sample_0"
    info = json.loads((sim / "sim_info.json").read_text())
    assert info["n_particles"] == 250 and info["median_render_ms"] is not None
    assert (sim / "frames" / "00000.png").exists()
    assert (sim / "ply_files" / "frame_00000.ply").exists()
    assert list((sim / "frames").glob("output.*"))  # compile_video ran


def test_main_cli_trains_a_capture_then_renders_it(tmp_path):
    """``pipeline.main`` runs pipeline.py's train_gaussians stage on the
    object's capture (the analytic sphere, 5 views at 32x32, 3 iterations
    from 5000 random points in the unit cube), then simulates and renders
    the checkpoint it trained: one frame of 40 substeps on the CPU (the tree
    config at frame_dt 4e-3), seen from the capture's camera 4 (cameras.json
    in the reference's layout).
    The object's voxel artifacts (placeholders) and material PLY (a jelly
    lattice over the cube) are given, so the voxel and neural stages find
    them and skip, as pipeline.py's do."""
    from test_recon import make_synthetic_blender_dataset

    from pixie_tpu.config import compose
    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.recon.gaussians import load_gaussian_ply
    from pixie_tpu_torch.recon.train_field import load_dataset
    from pixie_tpu_torch.recon.train_gaussians import blender_viewmat
    from pixie_tpu_torch.utils.io import make_material_vertex, write_ply
    from pixie_tpu_torch.utils.paths import get_output_paths, resolve_paths

    obj = "capture_obj"
    tree = json.loads((REPO / "config" / "objaverse" / "custom_tree_config.json").read_text())
    (tmp_path / "config" / "objaverse").mkdir(parents=True)
    (tmp_path / "config" / "objaverse" / "custom_tree_config.json").write_text(
        json.dumps({**tree, "frame_dt": 4e-3}))
    argv = [f"obj_id={obj}", f"paths.base_path={tmp_path}",
            f"paths.physgaussian_config_dir={tmp_path / 'config'}", "physics.n_frames=1",
            "training_3d.gs_iterations=3"]
    paths = get_output_paths(resolve_paths(compose(overrides=argv)), obj)
    data = make_synthetic_blender_dataset(Path(paths["data_dir"]), n_views=5, res=32)
    g = np.linspace(-0.55, 0.55, 12, dtype=np.float32)
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    k = len(lattice)
    art = pipeline.voxel_artifact_paths(paths["render_output"])
    for key in ("features", "mask"):
        Path(art[key]).parent.mkdir(parents=True, exist_ok=True)
        np.save(art[key], np.zeros((2, 2, 2), np.float32))
    write_ply(Path(paths["render_output"]) / "sample_0" / "mapped_preds.ply",
              make_material_vertex(coords=lattice, density=np.full(k, 200.0, np.float32),
                                   E=np.full(k, 2e6, np.float32), nu=np.full(k, 0.4, np.float32),
                                   material_id=np.zeros(k, np.int64)))
    gs = Path(paths["gs_output"])
    ds = load_dataset(data)
    cams = []
    for i, c2w in enumerate(ds["c2w"]):
        cv = np.linalg.inv(blender_viewmat(c2w))       # camera-to-world, +z forward
        cams.append({"id": i, "width": 32, "height": 32, "fx": ds["intrinsics"][0],
                     "fy": ds["intrinsics"][1], "position": cv[:3, 3].tolist(),
                     "rotation": cv[:3, :3].tolist()})
    gs.mkdir(parents=True)
    (gs / "cameras.json").write_text(json.dumps(cams))

    pipeline.main(argv, device="cpu")
    trained = load_gaussian_ply(gs / "point_cloud" / "iteration_3" / "point_cloud.ply")
    metrics = json.loads((gs / "metrics.json").read_text())
    assert len(trained["xyz"]) == metrics["n_gaussians"] == 5000
    assert len(metrics["psnr_per_view"]) == 5
    sim = tmp_path / "mpm_sim_outputs" / "neural" / obj / "sample_0"
    info = json.loads((sim / "sim_info.json").read_text())
    assert info["n_particles"] == 5000 and info["median_render_ms"] is not None
    assert (sim / "frames" / "00000.png").exists()
    assert (sim / "ply_files" / "frame_00000.ply").exists()
    # the frame's gaussians are the trained ones, moved by the rollout
    frame = load_gaussian_ply(sim / "ply_files" / "frame_00000.ply")
    np.testing.assert_array_equal(to_np(frame["f_dc"]), to_np(trained["f_dc"]))
    # a second run finds the checkpoint and skips training; no capture, no training
    before = (gs / "metrics.json").stat().st_mtime_ns
    assert pipeline.train_gaussians(paths["data_dir"], gs, iterations=3, device="cpu") is None
    assert (gs / "metrics.json").stat().st_mtime_ns == before
    assert pipeline.train_gaussians(tmp_path / "nowhere", tmp_path / "gs2", device="cpu") is None
