"""3DGS training, port vs JAX package, on the CPU: the differentiable tile
rasterizer (the port's plain blend backward against ``jax.grad`` through
JAX's Pallas kernels in interpret mode), SSIM, Adam, densify/prune, capture
loading, and the whole trainer against JAX's per-step loop.

Tolerances (float32 throughout):
  * rasterizer gradients, every param key and mean2d_offset: rtol 1e-4 and
    atol 1e-5 of the key's largest |grad| (measured: <= 3e-6 of it; the
    blends sum in different chunkings);
  * SSIM atol 1e-6; capture loading and densify/prune identical; three
    Adam steps atol 2e-6 (the same formula; optax's float32 rounding lands
    1.0e-6 from the float64 update after 3 steps at lr 0.05, torch's 2e-7);
  * trainer, 12 steps through a densify event and an opacity reset: the
    gaussian count identical; losses atol 5e-5 (measured 2e-7 dense, 5e-6
    tiled); PSNR within 1e-3 dB; every param within atol 1e-4 on at least
    98 % of the gaussians, and within Adam's reach on the rest.  The rest
    are gaussians whose gradient is ~0: an isotropic gaussian's rotation
    gradient is exactly 0 in exact arithmetic, each package rounds it to 0
    or to its own +-1e-13, and Adam at eps 1e-15 turns that into a full
    step of lr in a direction of its own (measured: up to 5 of 600).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import splat_scene, to_np, underflow_scene

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

CAM = (64, 64, 64.0, 64.0, 32.0, 32.0)


def _grads_both(p, vm, **kw):
    """d/d(params, mean2d_offset) of sum(img * A) + sum(alpha * B), bg 0.25,
    through JAX's rasterize_tiled and the port's; (jax, port) numpy dicts."""
    from pixie_tpu.recon import rasterizer as JR
    from pixie_tpu_torch.recon import rasterizer as TR

    n = p["xyz"].shape[0]
    rng = np.random.default_rng(9)
    wi = rng.normal(size=(CAM[0], CAM[1], 3)).astype(np.float32)
    wa = rng.normal(size=(CAM[0], CAM[1])).astype(np.float32)

    def jloss(jp, off):
        img, a = JR.rasterize_tiled(jp, jnp.asarray(vm), JR.Camera(*CAM), bg_color=0.25,
                                    mean2d_offset=off, **kw)
        return jnp.sum(img * wi) + jnp.sum(a * wa)

    jg, jo = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                             jnp.zeros((n, 2), jnp.float32))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    to = torch.zeros((n, 2), requires_grad=True)
    img, a = TR.rasterize_tiled(tp, torch.as_tensor(vm), TR.Camera(*CAM), bg_color=0.25,
                                mean2d_offset=to, **kw)
    (torch.sum(img * torch.as_tensor(wi)) + torch.sum(a * torch.as_tensor(wa))).backward()
    want = {**{k: np.asarray(v) for k, v in jg.items()}, "mean2d_offset": np.asarray(jo)}
    got = {**{k: to_np(v.grad) for k, v in tp.items()}, "mean2d_offset": to_np(to.grad)}
    return want, got


def _assert_grads_close(want, got):
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5 * scale, err_msg=k)


# name: (gaussians, kwargs); the slot-table cases are JAX's B5 branch
GRAD_CASES = {
    "stream": (120, dict(tile_cap=256)),
    "stream_tile_cap_binds": (600, dict(tile_cap=128)),
    "slot_table_64": (500, dict(tile_cap=64, chunk=64, max_tiles_side=4)),
    "slot_table_1280": (300, dict(tile_cap=1280)),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_rasterize_tiled_gradients_match_jax(case):
    from pixie_tpu_torch.recon import rasterizer as TR

    n, kw = GRAD_CASES[case]
    p, vm = splat_scene(n, seed=len(case))
    bins = TR.bin_tiles({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(vm),
                        TR.Camera(*CAM), tile_cap=kw["tile_cap"],
                        max_tiles_side=kw.get("max_tiles_side", 6))
    slot_table = TR.slot_table_chunk(kw["tile_cap"], kw.get("chunk", 128)) is not None
    assert slot_table == case.startswith("slot_table")
    assert not TR.jax_stream_overflows(bins)          # JAX's stream renders every tile
    binds = int(bins.raw.max()) > kw["tile_cap"]
    assert binds == (case in ("stream_tile_cap_binds", "slot_table_64"))
    _assert_grads_close(*_grads_both(p, vm, **kw))


def test_underflow_tile_gradients_match_jax():
    """Front splats of a tile whose T underflows to 0 get JAX's gradients."""
    from pixie_tpu_torch.recon import rasterizer as TR

    p, vm = underflow_scene()
    img, alpha = TR.rasterize_tiled({k: torch.as_tensor(v) for k, v in p.items()},
                                    torch.as_tensor(vm), TR.Camera(*CAM), bg_color=0.25)
    assert float((1.0 - alpha).min()) == 0.0          # T underflowed
    want, got = _grads_both(p, vm, tile_cap=256)
    _assert_grads_close(want, got)
    order = np.argsort(p["xyz"][60:, 2])[:10] + 60   # the stack's ten nearest splats
    for k in ("xyz", "opacity", "f_dc", "mean2d_offset"):
        assert float(np.abs(want[k][order]).max()) > 0.0, k
        np.testing.assert_allclose(got[k][order], want[k][order], rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want[k]).max()), err_msg=k)


def test_blend_backward_plain_matches_autograd_of_blend_plain():
    """The explicit per-chunk VJP against torch.autograd through the forward
    (float32: in float64 some alphas fall on the other side of 1/255)."""
    from pixie_tpu_torch.ops import gs_stream
    from pixie_tpu_torch.recon import rasterizer as TR

    p, vm = splat_scene(300, seed=2)
    bins = TR.bin_tiles({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(vm),
                        TR.Camera(*CAM), tile_cap=256)
    rng = np.random.default_rng(3)
    di = torch.as_tensor(rng.normal(size=(64, 64, 3)).astype(np.float32))
    dt = torch.as_tensor(rng.normal(size=(64, 64)).astype(np.float32))
    got = to_np(gs_stream.blend_backward_plain(bins.feat, bins.idx, bins.starts, bins.counts,
                                               bins.tx_n, 0.4, di, dt))
    feat = bins.feat.detach().clone().requires_grad_(True)
    img, trans = gs_stream.blend_plain(feat, bins.idx, bins.starts, bins.counts, bins.tx_n, 0.4)
    (torch.sum(img * di) + torch.sum(trans * dt)).backward()
    want = to_np(feat.grad)
    for c in range(9):
        scale = float(np.abs(want[:, c]).max())
        assert scale > 0.0
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=1e-4, atol=1e-5 * scale)


def test_rasterize_dense_gradients_match_jax():
    from pixie_tpu.recon import rasterizer as JR
    from pixie_tpu_torch.recon import rasterizer as TR

    p, vm = splat_scene(150, seed=4)
    cam = (32, 48, 50.0, 50.0, 24.0, 16.0)
    n = p["xyz"].shape[0]

    def jloss(jp, off):
        img, a = JR.rasterize(jp, jnp.asarray(vm), JR.Camera(*cam), bg_color=0.3,
                              mean2d_offset=off)
        return jnp.sum(img * img) + jnp.sum(a)

    jg, jo = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                             jnp.zeros((n, 2), jnp.float32))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    to = torch.zeros((n, 2), requires_grad=True)
    img, a = TR.rasterize(tp, torch.as_tensor(vm), TR.Camera(*cam), bg_color=0.3,
                          mean2d_offset=to)
    (torch.sum(img * img) + torch.sum(a)).backward()
    want = {**{k: np.asarray(v) for k, v in jg.items()}, "mean2d_offset": np.asarray(jo)}
    _assert_grads_close(want, {**{k: to_np(v.grad) for k, v in tp.items()},
                               "mean2d_offset": to_np(to.grad)})


# -- trainer pieces -------------------------------------------------------------

def test_ssim_and_viewmat_match_jax():
    from pixie_tpu.recon import train_gaussians as JT
    from pixie_tpu_torch.recon import train_gaussians as TT

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = float(JT.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(TT.ssim(torch.as_tensor(a), torch.as_tensor(b)))
    assert abs(got - want) <= 1e-6 and 0.3 < want < 0.99
    np.testing.assert_array_equal(TT._gauss_band(40, 11, 1.5), JT._gauss_band(40, 11, 1.5))
    c2w = np.linalg.inv(np.asarray(splat_scene(1)[1], np.float64))
    np.testing.assert_array_equal(TT.blender_viewmat(c2w), JT.blender_viewmat(c2w))


def test_adam_groups_match_optax():
    """Three steps of the per-key Adam against optax's (eps 1e-15 outside
    the square root, lr_xyz x spatial_scale, f_rest at lr_feature / 20)."""
    from pixie_tpu.recon import train_gaussians as JT
    from pixie_tpu_torch.recon import train_gaussians as TT

    p, _ = splat_scene(50, seed=7)
    cfg = TT.GSTrainConfig()
    tx = JT.make_optimizer(JT.GSTrainConfig(), 2.5)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    opt = TT.make_optimizer(tp, cfg, 2.5)
    assert [g["name"] for g in opt.param_groups] == list(TT.PARAM_KEYS)
    rng = np.random.default_rng(8)
    for _ in range(3):
        grads = {k: rng.normal(0.0, 1e-3, v.shape).astype(np.float32) for k, v in p.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        for k, v in tp.items():
            v.grad = torch.as_tensor(grads[k])
        opt.step()
    for k in p:
        np.testing.assert_allclose(to_np(tp[k]), np.asarray(jp[k]), atol=2e-6, rtol=0,
                                   err_msg=k)


def test_densify_and_prune_matches_jax():
    from pixie_tpu.recon import train_gaussians as JT
    from pixie_tpu_torch.recon import train_gaussians as TT

    p, _ = splat_scene(200, seed=3)
    p["opacity"][:20] = -8.0                           # pruned
    rng = np.random.default_rng(1)
    accum = rng.uniform(0, 4e-3, 200).astype(np.float32)
    denom = rng.integers(0, 5, 200).astype(np.float32)
    cfg = TT.GSTrainConfig(densify_grad_threshold=5e-4)
    want = JT.densify_and_prune({k: jnp.asarray(v) for k, v in p.items()}, accum, denom,
                                JT.GSTrainConfig(densify_grad_threshold=5e-4), 200, 1.3,
                                np.random.default_rng(4))
    got = TT.densify_and_prune({k: torch.as_tensor(v) for k, v in p.items()}, accum, denom,
                               cfg, 1.3, np.random.default_rng(4))
    assert 200 - 20 < len(got["xyz"]) != 200
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_capture_loading_and_psnr_match_jax(tmp_path):
    from test_colmap import _write_synthetic_model
    from test_recon import make_synthetic_blender_dataset

    from pixie_tpu.recon.train_field import load_dataset as j_load
    from pixie_tpu.utils.metrics import psnr as j_psnr
    from pixie_tpu_torch.recon.train_field import load_dataset as t_load
    from pixie_tpu_torch.utils.metrics import psnr as t_psnr

    make_synthetic_blender_dataset(tmp_path / "blender", n_views=2, res=16)
    _write_synthetic_model(tmp_path / "colmap", n_views=3, n_pts=20, binary=True)
    for root in (tmp_path / "blender", tmp_path / "colmap"):
        want, got = j_load(root), t_load(root)
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k
    with pytest.raises(FileNotFoundError):
        t_load(tmp_path)
    a = want["images"][0]
    assert t_psnr(a * 0.9, a) == j_psnr(a * 0.9, a) and t_psnr(a, a) == float("inf")


# -- the trainer ----------------------------------------------------------------

@pytest.fixture(scope="module", params=["dense", "tiled"])
def trained(request, tmp_path_factory):
    """Both trainers, 12 steps with a forced densify event at step 8 and an
    opacity reset at step 10, on the analytic sphere capture: 24x24 views on
    the dense path; 64x64 views with tiled="on" at tile_cap 1024.  The tiled
    sizes keep JAX's padded capacity <= tile_cap and its stream unfilled,
    so JAX's padding rows change no tile list (asserted below)."""
    import pixie_tpu.recon.train_gaussians as JT
    import pixie_tpu_torch.recon.train_gaussians as TT
    from test_recon import make_synthetic_blender_dataset

    tiled = request.param == "tiled"
    root = tmp_path_factory.mktemp(f"gs_{request.param}")
    data = make_synthetic_blender_dataset(root / "data", n_views=4, res=64 if tiled else 24)
    kw = dict(iterations=12, densify_from=4, densify_until=12, densify_interval=8,
              densify_grad_threshold=1e-7, opacity_reset_interval=10, seed=0)
    if tiled:
        kw.update(tiled="on", tile_cap=1024)
    n, ext = (300, 0.25) if tiled else (200, 0.4)
    init = np.random.default_rng(0).uniform(-ext, ext, (n, 3)).astype(np.float32)

    j_terms = []   # JAX's per-step (l1, ssim), read from inside its jitted step
    j_ssim = JT.ssim

    def recording_ssim(a, b, *rest):
        s = j_ssim(a, b, *rest)
        jax.debug.callback(lambda l1, s: j_terms.append((float(l1), float(s))),
                           jnp.abs(a - b).mean(), s)
        return s

    mp = pytest.MonkeyPatch()
    mp.setattr(JT, "ssim", recording_ssim)
    mp.setenv("PIXIE_GS_SCAN", "0")
    try:
        jf = JT.train_gaussian_splatting(data, root / "jax", cfg=JT.GSTrainConfig(**kw),
                                         init_points=init, log_every=1000)
    finally:
        mp.undo()
    steps = []
    tf = TT.train_gaussian_splatting(
        data, root / "torch", cfg=TT.GSTrainConfig(**kw), init_points=init, log_every=1000,
        device="cpu", on_step=lambda it, loss, l1, n: steps.append((float(loss), n)))
    j_loss = [0.8 * l1 + 0.2 * (1.0 - s) for l1, s in j_terms]
    return dict(root=root, jax=jf, torch=tf, j_loss=j_loss, steps=steps, tiled=tiled,
                n=n, data=data)


def test_trainer_count_and_params_match_jax(trained):
    jf, tf = trained["jax"], trained["torch"]
    counts = [n for _, n in trained["steps"]]
    assert counts[7] == trained["n"] < counts[8] == counts[-1]   # the densify fired at step 8
    assert len(tf["xyz"]) == len(jf["xyz"]) == counts[-1]
    assert set(tf) == set(jf)
    n = counts[-1]
    for k in jf:
        got, want = to_np(tf[k]).reshape(n, -1), np.asarray(jf[k]).reshape(n, -1)
        off = np.abs(got - want).max(1)
        assert (off <= 1e-4).mean() >= 0.98, (k, int((off > 1e-4).sum()))
        # Adam moves a param by at most ~3.2 lr a step (|m_hat| / sqrt(v_hat))
        lr = {"xyz": 1.6e-4 * 4.0, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05,
              "scaling": 5e-3, "rotation": 1e-3}[k]
        assert off.max() <= 3.2 * 12 * lr, (k, off.max())
    # the opacity reset capped every opacity at logit(0.01), then two steps moved it
    assert float(to_np(tf["opacity"]).max()) < float(np.log(0.01 / 0.99)) + 2 * 0.05 * 3.2


def test_trainer_losses_match_jax(trained):
    losses = [l for l, _ in trained["steps"]]
    assert len(losses) == len(trained["j_loss"]) == 12
    np.testing.assert_allclose(losses, trained["j_loss"], atol=5e-5, rtol=0)
    assert losses[-1] < losses[0]


def test_trainer_artifacts_match_jax(trained):
    """The same checkpoint PLY layout and metrics.json keys; PSNR within
    1e-3 dB; and the tiled run's tile lists were never cut by tile_cap nor
    JAX's stream (so JAX's padding rows changed nothing)."""
    from pixie_tpu.recon.gaussians import load_gaussian_ply as j_load_ply
    from pixie_tpu_torch.recon import rasterizer as TR
    from pixie_tpu_torch.recon.train_field import load_dataset
    from pixie_tpu_torch.recon.train_gaussians import blender_viewmat

    root = trained["root"]
    jm = json.loads((root / "jax" / "metrics.json").read_text())
    tm = json.loads((root / "torch" / "metrics.json").read_text())
    assert sorted(tm) == sorted(jm) == ["n_gaussians", "psnr_mean", "psnr_per_view", "train_s"]
    assert tm["n_gaussians"] == jm["n_gaussians"]
    assert abs(tm["psnr_mean"] - jm["psnr_mean"]) <= 1e-3
    np.testing.assert_allclose(tm["psnr_per_view"], jm["psnr_per_view"], atol=1e-3)
    ply = Path("point_cloud") / "iteration_12" / "point_cloud.ply"
    got, want = j_load_ply(root / "torch" / ply), j_load_ply(root / "jax" / ply)
    assert {k: np.asarray(v).shape for k, v in got.items()} == {
        k: np.asarray(v).shape for k, v in want.items()}
    if trained["tiled"]:
        ds = load_dataset(trained["data"])
        n = tm["n_gaussians"]
        cap = int(2 ** np.ceil(np.log2(n)))            # JAX's capacity after the densify
        p = {k: torch.as_tensor(np.array(v)) for k, v in trained["jax"].items()}
        pad = {"xyz": 0.0, "f_dc": 0.0, "f_rest": 0.0, "opacity": -20.0, "scaling": -20.0}
        for k, v in p.items():
            block = torch.full((cap - n, *v.shape[1:]), pad.get(k, 0.0))
            if k == "rotation":
                block[:, 0] = 1.0
            p[k] = torch.cat([v, block])
        for c2w in ds["c2w"]:
            bins = TR.bin_tiles(p, torch.as_tensor(blender_viewmat(c2w)),
                                TR.Camera(64, 64, *ds["intrinsics"]), tile_cap=1024)
            assert int(bins.raw.max()) <= 1024 and not TR.jax_stream_overflows(bins)
