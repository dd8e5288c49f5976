"""Field training, port vs JAX package, on the CPU: ray construction, the
learning-rate schedule with Adam, the trainer against JAX's per-step loop
(``PIXIE_FIELD_SCAN=0``), and the pipeline's ``train_nerf`` stage with its
CLI.  The trainer runs the small fields of tests/field_parity.py with the
shipped ProposalField; JAX's initial parameters and draws (its trainer's
init calls and key sequence) are handed to the port.

Tolerances:
  * ray construction (origins, dirs, rgb, the nearest patch's feature):
    exact;
  * Adam and the decayed learning rate against optax over 5 steps: 2e-6
    absolute;
  * trainer, 6 steps of the proposal path with 16-wide features on
    hashgrid: losses within 1e-5 of the first loss (measured 5.9e-7); every
    parameter tensor's median offset within 1e-4 (measured: 3e-8 on the
    nerf field, 7.5e-6 on the feature field, 5.9e-5 on the proposal field)
    and its largest within Adam's reach (3.2 lr a step).  The sample
    positions agree to a few ulps (tests/test_torch_field_render.py), and
    the proposal field's gradients are rounded to bfloat16 at other places
    in the two packages; Adam at eps 1e-15 turns a gradient of ~0, whose
    sign such roundings settle, into a full step of lr (all but 0.2 % of
    the nerf table, 1.2 % of the feature table, 7.3 % of the proposal
    table's entries within 1e-4);
  * held-out PSNR within 1e-2 dB.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from field_parity import (
    FEAT_DIM, JF, RCFG, TF, JSmallFeat, JSmallNerf, _jax_draws, _port_fields,
)
from torch_parity import to_np

from pixie_tpu_torch.recon import train_field as TT


# -- rays, schedule and Adam ---------------------------------------------------------

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    from test_recon import make_synthetic_blender_dataset

    root = tmp_path_factory.mktemp("field_capture")
    data = make_synthetic_blender_dataset(root / "data", n_views=4, res=24)
    feats = np.random.default_rng(0).normal(size=(4, 3, 4, FEAT_DIM)).astype(np.float16)
    np.save(root / "feats.npy", feats)
    return root, data, feats


def test_rays_from_pixels_match_make_ray_fn(capture):
    from pixie_tpu.recon.train_field import make_ray_fn

    _, data, feats = capture
    ds = TT.load_dataset(data)
    key = jax.random.PRNGKey(3)
    want = make_ray_fn(ds, feats)(key, 200)
    k1, k2, k3 = jax.random.split(key, 3)
    h, w = ds["hw"]
    img_idx = np.asarray(jax.random.randint(k1, (200,), 0, 4))
    px = np.asarray(jax.random.randint(k2, (200,), 0, w))
    py = np.asarray(jax.random.randint(k3, (200,), 0, h))
    got = TT.make_ray_fn(ds, feats, device="cpu")(
        *(torch.as_tensor(a, dtype=torch.int64) for a in (img_idx, py, px)))
    for g, wnt, name in zip(got, want, ("origins", "dirs", "rgb", "feature")):
        assert to_np(g).dtype == np.asarray(wnt).dtype, name
        np.testing.assert_array_equal(to_np(g), np.asarray(wnt), err_msg=name)


def test_adam_and_learning_rate_match_optax():
    import optax

    cfg = TT.FieldTrainConfig(max_iterations=7, lr=1e-2, lr_final=1e-4)
    sched = optax.exponential_decay(cfg.lr, cfg.max_iterations, cfg.lr_final / cfg.lr)
    for it in range(cfg.max_iterations + 1):
        assert TT.learning_rate(cfg, it) == pytest.approx(float(sched(it)), rel=1e-6)
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(50,)).astype(np.float32)
    grads = [rng.normal(size=(50,)).astype(np.float32) * (10.0 ** -k) for k in range(5)]
    tx = optax.adam(sched, b1=0.9, b2=0.99, eps=1e-15)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = torch.optim.Adam([tp], lr=cfg.lr, betas=(0.9, 0.99), eps=1e-15)
    for it, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.as_tensor(g)
        for group in opt.param_groups:
            group["lr"] = TT.learning_rate(cfg, it)
        opt.step()
        np.testing.assert_allclose(to_np(tp), np.asarray(jp), rtol=0, atol=2e-6)


# -- the trainer ---------------------------------------------------------------------

STEPS = 6


@pytest.fixture(scope="module")
def trained(capture):
    """Both trainers, 6 steps of the proposal path with 16-wide features on
    hashgrid (SmallNerf / SmallFeat in both packages), JAX's initial
    parameters and draws in the port; JAX's per-step rgb, prop_loss,
    feature and targets recorded from inside its jitted step."""
    import pixie_tpu.recon.train_field as JT

    root, data, _ = capture
    kw = dict(max_iterations=STEPS, rays_per_batch=128, encoding="hashgrid", eval_views=1,
              render=None)
    jcfg = JT.FieldTrainConfig(**dict(kw, render=JF.RenderConfig(**RCFG)))
    tcfg = TT.FieldTrainConfig(**dict(kw, render=TF.RenderConfig(**RCFG)))

    j_out, j_gt = [], []
    j_render, j_make_ray_fn = JT.render_rays_prop, JT.make_ray_fn

    def recording_render(*a, **k):
        out = j_render(*a, **k)
        if k.get("train", True):
            jax.debug.callback(lambda *v: j_out.append([np.asarray(x) for x in v]),
                               out["rgb"], out["prop_loss"], out["feature"])
        return out

    def recording_make_ray_fn(ds, fm=None):
        sample = j_make_ray_fn(ds, fm)

        def s(rng, n):
            o, d, rgb, f = sample(rng, n)
            jax.debug.callback(lambda *v: j_gt.append([np.asarray(x) for x in v]), rgb, f)
            return o, d, rgb, f
        return s

    mp = pytest.MonkeyPatch()
    mp.setattr(JT, "render_rays_prop", recording_render)
    mp.setattr(JT, "make_ray_fn", recording_make_ray_fn)
    mp.setattr(JT, "NerfField", JSmallNerf)
    mp.setattr(JT, "FeatureField", JSmallFeat)
    mp.setenv("PIXIE_FIELD_SCAN", "0")
    try:
        jparams = JT.train_feature_field(data, root / "jax", cfg=jcfg,
                                         features_path=root / "feats.npy", log_every=1000)
    finally:
        mp.undo()

    # JAX's initial parameters (its trainer's init calls) and draws (its key
    # sequence: a split a step, then ray and render keys)
    rng, dummy = jax.random.PRNGKey(jcfg.seed), jnp.zeros((8, 3))
    init = {"nerf": JSmallNerf(encoding="hashgrid").init(rng, dummy, dummy, False),
            "feat": JSmallFeat(encoding="hashgrid").init(jax.random.fold_in(rng, 7), dummy),
            "prop": JF.ProposalField().init(jax.random.fold_in(rng, 13), dummy)}
    draws = []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        kray, krender = jax.random.split(sub)
        k1, k2, k3 = jax.random.split(kray, 3)
        n = jcfg.rays_per_batch
        idx = [jax.random.randint(k1, (n,), 0, 3), jax.random.randint(k3, (n,), 0, 24),
               jax.random.randint(k2, (n,), 0, 24)]
        draws.append((*(torch.as_tensor(np.asarray(a), dtype=torch.int64) for a in idx),
                      tuple(map(torch.as_tensor, _jax_draws(krender, n, jcfg.render)))))

    def jax_init(cfg, with_features, device="cuda"):
        assert with_features
        return {k: m for k, m in _port_fields("hashgrid", init).items()}

    steps = []
    mp.setattr(TT, "init_fields", jax_init)
    mp.setattr(TT, "draw_step", lambda *a: draws[len(steps)])
    try:
        tparams = TT.train_feature_field(data, root / "torch", cfg=tcfg,
                                         features_path=root / "feats.npy", log_every=1000,
                                         device="cpu",
                                         on_step=lambda it, loss: steps.append(float(loss)))
    finally:
        mp.undo()
    j_loss = [float(np.mean((rgb - gt) ** 2) + p + 1e-3 * np.mean(
        (f - fgt.astype(np.float32)) ** 2)) for (rgb, p, f), (gt, fgt) in zip(j_out, j_gt)]
    return dict(root=root, jax=jparams, torch=tparams, j_loss=j_loss, steps=steps, cfg=tcfg)


def test_trainer_losses_match_jax(trained):
    losses, want = trained["steps"], trained["j_loss"][:STEPS]
    assert len(losses) == len(want) == STEPS
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5 * want[0])
    assert np.isfinite(losses).all()


def test_trainer_params_match_jax(trained):
    cfg = trained["cfg"]
    for name, module in trained["torch"].items():
        want = TF.state_dict_from_jax(trained["jax"][name])
        got = module.state_dict()
        assert set(got) == set(want), name
        for k, v in got.items():
            off = np.abs(to_np(v) - to_np(want[k]))
            assert np.median(off) <= 1e-4, (name, k, float(np.median(off)))
            assert off.max() <= 3.2 * STEPS * cfg.lr, (name, k, off.max())


def test_trainer_outputs_match_jax(trained):
    root = trained["root"]
    jm = json.loads((root / "jax" / "metrics.json").read_text())
    tm = json.loads((root / "torch" / "metrics.json").read_text())
    assert set(tm) == set(jm) == {"train_s", "final_loss", "psnr_per_view", "psnr_mean"}
    assert tm["final_loss"] == pytest.approx(jm["final_loss"], rel=1e-5)
    np.testing.assert_allclose(tm["psnr_per_view"], jm["psnr_per_view"], rtol=0, atol=1e-2)
    meta = json.loads((root / "torch" / "checkpoints" / "field_meta.json").read_text())
    assert meta == {"feature_dim": FEAT_DIM, "with_features": True, "encoding": "hashgrid"}
    ckpt = TT.load_field_checkpoint(root / "torch")
    assert set(ckpt) == {"nerf", "feat", "prop"}


# -- the pipeline stage --------------------------------------------------------------

T3 = {"nerf_max_num_iterations": 3, "nerf_rays_per_batch": 64, "nerf_n_coarse": 8,
      "nerf_n_fine": 8}


def test_train_nerf_rgb_only_without_clip_weights(capture, tmp_path, monkeypatch, caplog):
    from pixie_tpu_torch import pipeline

    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "no_hub"))
    _, data, _ = capture
    out = tmp_path / "f3rm"
    with caplog.at_level("WARNING"):
        fields = pipeline.train_nerf(data, out, training_3d=T3, device="cpu")
    assert set(fields) == {"nerf", "prop"}
    assert "CLIP weights unavailable" in caplog.text
    assert not (out / "clip_patch_features.npy").exists()
    meta = json.loads((out / "checkpoints" / "field_meta.json").read_text())
    assert meta == {"feature_dim": 768, "with_features": False, "encoding": "mxu"}
    assert set(json.loads((out / "metrics.json").read_text())) == {
        "train_s", "final_loss", "psnr_per_view", "psnr_mean"}
    # the stage skips once the checkpoint exists, and without a capture
    assert pipeline.train_nerf(data, out, training_3d=T3, device="cpu") is None
    assert pipeline.train_nerf(tmp_path / "empty", tmp_path / "f2", device="cpu") is None
    vox = pipeline.generate_voxels(out, tmp_path / "render", grid_size=8, batch_size=128,
                                   device="cpu")
    pipeline.finish_voxel_fetch(vox)
    # no feature field: the voxelizer's features are density and 0, as in JAX
    assert np.load(vox["features"]).shape == (8, 8, 8, 2)


def test_train_nerf_distills_the_extracted_features(capture, tmp_path, monkeypatch):
    """A seeded CLIP snapshot in the hub cache's layout: train_nerf extracts
    the views' features into clip_patch_features.npy, trains the feature
    field at their width, and generate_voxels reads the checkpoint."""
    from torch_parity import TINY_CLIP, write_clip_snapshot

    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.recon.clip_features import CLIPArgs

    hub = tmp_path / "hub"
    write_clip_snapshot(hub / ("models--" + CLIPArgs.model_name.replace("/", "--"))
                        / "snapshots" / "seeded", TINY_CLIP, seed=0)
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    _, data, _ = capture
    out = tmp_path / "f3rm"
    fields = pipeline.train_nerf(data, out, training_3d=T3, device="cpu")
    feats = np.load(out / "clip_patch_features.npy")
    side = TINY_CLIP["image_size"] // TINY_CLIP["patch_size"]
    assert feats.dtype == np.float16 and feats.shape == (4, side, side, TINY_CLIP["hidden_size"])
    assert fields["feat"].mlp.out.out_features == TINY_CLIP["hidden_size"]
    vox = pipeline.generate_voxels(out, tmp_path / "render", grid_size=8, batch_size=128,
                                   device="cpu")
    pipeline.finish_voxel_fetch(vox)
    assert np.load(vox["features"]).shape == (8, 8, 8, TINY_CLIP["hidden_size"])


def test_train_nerf_raises_other_errors(capture, tmp_path, monkeypatch):
    """Only missing CLIP weights fall back to RGB-only training."""
    from pixie_tpu_torch import pipeline
    from pixie_tpu_torch.recon import clip_features

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(clip_features, "extract_clip_features", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pipeline.train_nerf(capture[1], tmp_path / "f3rm", training_3d=T3, device="cpu")


def test_train_field_cli_defaults_to_cuda(capture, tmp_path, monkeypatch):
    import dataclasses
    import inspect

    from pixie_tpu_torch import pipeline

    for fn in (TT.train_feature_field, TT.make_ray_fn, TT.render_full_view, TT.evaluate_field,
               TT.init_fields, pipeline.train_nerf):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    monkeypatch.setitem(TT.METHOD_CONFIGS, "nerfacto", dataclasses.replace(
        TT.METHOD_CONFIGS["nerfacto"], rays_per_batch=64, render=TF.RenderConfig(8, 8)))
    TT.main(["--data", str(capture[1]), "--output", str(tmp_path / "cli"), "--iters", "2",
             "--method", "nerfacto", "--device", "cpu"])
    assert (tmp_path / "cli" / "checkpoints" / "field.pth").exists()
