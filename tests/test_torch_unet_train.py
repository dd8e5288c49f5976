"""U-Net training, port vs JAX package, on the CPU: the masked metrics, both
losses, the gradients, the learning-rate schedule, gradient clipping, the
trainer's steps and eval, checkpoints, ``train_loop`` and 2-process DDP.

Sizes: tests/test_training.py:41 ``SMALL``.  Both packages start from the
same seeded weights (the port's ``seeded_state_dict`` carried into flax by
the JAX package's ``convert_torch.convert_state_dict``); the JAX trainer
runs on a 1-device mesh, so no padding row enters its accuracy.

Tolerances:
  * masked_mean, compute_accuracy, mean_se_ci90, both losses: float32
    rounding, rtol 1e-6 (the sums run in another order); empty masks and
    all-background batches give exactly 0;
  * the gradient of every parameter tensor against ``jax.grad`` of JAX's
    loss: within 1e-4 of that tensor's largest |gradient| (XLA's and
    oneDNN's convolutions sum in other orders; measured <= 5.7e-6), or of
    1e-3 of the net's largest where that is larger: the biases ahead of a
    norm have gradients 0 in exact arithmetic, rounding noise of ~1e-9;
  * the learning rate against the optax schedule at every step: rtol 1e-6
    (optax computes it in float32);
  * clip_by_global_norm against optax's on both sides of the threshold:
    rtol 1e-6;
  * 5 train_steps a mode (lr 1e-3 halved every 2 steps): losses and metrics
    rtol 1e-5; final params within Adam's reach (3.2 x the sum of the
    steps' learning rates: its normalized step turns a last-bit gradient
    difference near 0 into one of up to ~lr), their median difference
    within 1e-6 and under 1e-3 of the median move;
  * eval_step: rtol 1e-5;
  * checkpoint round trip and resume on the CPU: bitwise;
  * DDP (2 and 4 gloo processes): the ranks' averaged gradient within 1e-4 of
    one process's gradient on the whole batch, by the same per-tensor scale
    (float32 sums split over the ranks; the average of the halves' own
    masked means' gradients is off by more than 10 % on the first batch).
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets the torch thread count)
from torch_parity import to_np
from unet_train_parity import SMALL, ddp_batches, run_ddp, seeded_params

from pixie_tpu.models.convert_torch import convert_state_dict
from pixie_tpu.parallel.mesh import get_mesh
from pixie_tpu.train import trainer as JT
from pixie_tpu.utils import metrics as JM
from pixie_tpu_torch.models.convert import state_dict_from_jax
from pixie_tpu_torch.train import trainer as TT
from pixie_tpu_torch.utils import metrics as TM

D = SMALL["grid_size"]
# a conv bias ahead of a spatial LayerNorm or GroupNorm adds a constant that
# the norm removes: its gradient is 0 in exact arithmetic and rounding noise
# (~1e-9 against a largest gradient of ~0.1) in both packages, so each
# tensor's scale is at least this share of the net's largest gradient
GRAD_FLOOR = 1e-3
ARCH = dict(num_res_blocks=SMALL["num_res_blocks"], channel_mult=SMALL["channel_mult"])


def _batch(rng, b=2, d=D, fc=SMALL["feature_channels"], fg=0.4):
    """(feat, cont, mat_id, mask) in the dataset's layout: ids 0-6 inside
    the mask, 7 outside."""
    feat = rng.normal(size=(b, d, d, d, fc)).astype(np.float32)
    mask = (rng.uniform(size=(b, d, d, d)) < fg).astype(np.float32)
    mat_id = np.where(mask > 0, rng.integers(0, 7, (b, d, d, d)), 7).astype(np.int64)
    cont = rng.uniform(-1, 1, (b, d, d, d, 3)).astype(np.float32)
    return feat, cont, mat_id, mask


def _mode_batch(mode, feat, cont, mat_id, mask):
    return (feat, mat_id, mask) if mode == "discrete" else (feat, cont, mask)


def _close_by_tensor(got: dict, want: dict, rtol: float):
    """Every tensor of ``got`` within ``rtol`` of ``want``'s largest |value|,
    or of GRAD_FLOOR times the largest |value| of all tensors where that is
    larger; returns the worst ratio."""
    assert set(got) == set(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    worst = 0.0
    for k in want:
        g, w = to_np(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        err = float(np.abs(g - w).max()) / scale
        assert err <= rtol, (k, err)
        worst = max(worst, err)
    return worst


# -- metrics and losses -----------------------------------------------------------

@pytest.mark.parametrize("dims,empty", [((1, 2, 3), False), ((1, 2, 3), True), ((0, 1), False)])
def test_masked_mean_matches_jax(dims, empty):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 5, 6)).astype(np.float32)
    m = (rng.uniform(size=x.shape) < 0.3).astype(np.float32) * (0.0 if empty else 1.0)
    got = to_np(TM.masked_mean(torch.as_tensor(x), torch.as_tensor(m), dims))
    want = np.asarray(JM.masked_mean(jnp.asarray(x), jnp.asarray(m), dims))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if empty:
        assert (got == 0).all()


@pytest.mark.parametrize("case", ["ignore", "mask", "empty_mask", "all_background"])
def test_compute_accuracy_matches_jax(case):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 8, 4, 4, 4)).astype(np.float32)
    target = rng.integers(0, 8, (2, 4, 4, 4))
    if case == "all_background":
        target[:] = 7
    mask = None
    if case in ("mask", "empty_mask"):
        mask = (rng.uniform(size=target.shape) < 0.5) * (case == "mask")
    got = TM.compute_accuracy(torch.as_tensor(logits), torch.as_tensor(target),
                              None if mask is None else torch.as_tensor(mask), ignore_index=7)
    want = JM.compute_accuracy(jnp.asarray(logits), jnp.asarray(target),
                               None if mask is None else jnp.asarray(mask), ignore_index=7)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    if case in ("empty_mask", "all_background"):
        assert float(got) == 0.0 and not np.isnan(float(got))


@pytest.mark.parametrize("values", [[0.5], [0.1, 0.4, 0.35, 0.9], []])
def test_mean_se_ci90_matches_jax(values):
    got, want = TM.mean_se_ci90(np.array(values)), JM.mean_se_ci90(np.array(values))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_equal(got[k], want[k])


@pytest.mark.parametrize("case", ["plain", "weights", "all_background"])
def test_discrete_loss_matches_jax(case):
    rng = np.random.default_rng(2)
    feat, _, mat_id, mask = _batch(rng, b=3)
    logits = rng.normal(size=mat_id.shape + (8,)).astype(np.float32) * 3
    if case == "all_background":
        mat_id[:] = 7
    w = np.array([1.0, 0.0, 1.0], np.float32) if case == "weights" else None
    got = TT.discrete_loss(torch.as_tensor(logits), torch.as_tensor(mat_id),
                           torch.as_tensor(mask), 7, None if w is None else torch.as_tensor(w))
    want = JT.discrete_loss(jnp.asarray(logits), jnp.asarray(mat_id), jnp.asarray(mask), 7,
                            None if w is None else jnp.asarray(w))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    if case == "all_background":
        assert float(got) == 0.0
    else:
        assert float(got) > 0.5


@pytest.mark.parametrize("weights", [None, [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
def test_continuous_loss_matches_jax(weights):
    rng = np.random.default_rng(3)
    _, cont, _, mask = _batch(rng, b=3)
    mask[1] = 0.0    # a sample with no foreground
    pred = rng.uniform(-1, 1, cont.shape).astype(np.float32)
    w = None if weights is None else np.asarray(weights, np.float32)
    got, got_aux = TT.continuous_loss(torch.as_tensor(pred), torch.as_tensor(cont),
                                      torch.as_tensor(mask), 2.0,
                                      None if w is None else torch.as_tensor(w))
    want, want_aux = JT.continuous_loss(jnp.asarray(pred), jnp.asarray(cont), jnp.asarray(mask),
                                        2.0, None if w is None else jnp.asarray(w))
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=0)
    assert set(got_aux) == set(want_aux) == {"density_mse", "youngs_mse", "poisson_mse"}
    for k in want_aux:
        assert float(got_aux[k]) == pytest.approx(float(want_aux[k]), rel=1e-6)


# -- schedule and clipping -----------------------------------------------------------

@pytest.mark.parametrize("decay", [True, False])
def test_learning_rate_matches_optax(decay):
    """Every update of 3 epochs of 4 steps against JAX's schedule
    (optax.exponential_decay, staircase, at the count of updates made)."""
    import optax

    steps_per_epoch = 4
    cfg = TT.TrainConfig(lr=3e-4, lr_decay=decay, lr_decay_rate=0.9)
    sched = optax.exponential_decay(3e-4, steps_per_epoch, 0.9, staircase=True)
    for k in range(3 * steps_per_epoch):
        want = float(sched(k)) if decay else 3e-4
        assert TT.learning_rate(cfg, steps_per_epoch, k) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    import optax

    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (5,), (2, 2, 2))]
    max_norm = 1.0
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    assert (norm < max_norm) == (scale == 0.1)
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.as_tensor(g.copy()) for g in grads]
    got_norm = TT.clip_by_global_norm(got, max_norm)
    assert float(got_norm) == pytest.approx(norm, rel=1e-6)
    for g, w, g0 in zip(got, want, grads):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-6, atol=0)
        if scale == 0.1:
            np.testing.assert_array_equal(to_np(g), g0)


# -- the trainer against JAX's -------------------------------------------------------

STEPS, STEPS_PER_EPOCH, LR = 5, 2, 1e-3
# Adam moves a parameter by at most ~3.2 lr a step (m / sqrt(v) at b1 0.9, b2
# 0.999), which a sign flip of a near-zero gradient can fully take
ADAM_REACH = 3.2


@pytest.fixture(scope="module", params=["discrete", "continuous"])
def runs(request):
    """Both trainers from the same weights: JAX's gradient of its loss at
    the start, eval_step, then STEPS train_steps on distinct batches."""
    mode = request.param
    cfg_kw = dict(mode=mode, batch_size=2, lr=LR, lr_decay_rate=0.5, **SMALL)
    sd = seeded_params(TT.TrainConfig(**cfg_kw), seed=3)
    rng = np.random.default_rng(5)
    batches = [_mode_batch(mode, *_batch(rng)) for _ in range(STEPS)]
    w = np.ones(2, np.float32)

    jparams = convert_state_dict(sd, **ARCH)["params"]
    jtr = JT.Trainer(JT.TrainConfig(**cfg_kw), mesh=get_mesh(devices=jax.devices()[:1]))
    jtr.setup(STEPS_PER_EPOCH, params=jparams)

    def jloss(params, feat, target, mask, w):
        out = jtr.model.apply({"params": params}, feat)
        if mode == "discrete":
            return JT.discrete_loss(out, target, mask, 7, w)
        return JT.continuous_loss(out, target, mask, 1.0, w)[0]

    jgrad = jax.jit(jax.grad(jloss))(jtr.params, *(jnp.asarray(x) for x in batches[0]),
                                     jnp.asarray(w))
    jeval = jtr.eval_step(batches[1])
    jsteps = []
    for b in batches:
        loss, aux = jtr.train_step(b)
        jsteps.append((float(loss), {k: float(v) for k, v in aux.items()}))
    jfinal = state_dict_from_jax(jax.device_get(jtr.params), **ARCH)

    ttr = TT.Trainer(TT.TrainConfig(**cfg_kw), device="cpu")
    ttr.setup(STEPS_PER_EPOCH, params=sd)
    teval = ttr.eval_step(batches[1])
    tsteps, tgrad = [], None
    for b in batches:
        tsteps.append(ttr.train_step(b))
        if tgrad is None:
            tgrad = {n: p.grad.clone() for n, p in ttr.model.named_parameters()}
    return dict(mode=mode, jgrad=state_dict_from_jax(jax.device_get(jgrad), **ARCH),
                tgrad=tgrad, jeval=jeval, teval=teval, jsteps=jsteps, tsteps=tsteps,
                jfinal=jfinal, tfinal=ttr.model.state_dict(), trainer=ttr)


def test_gradients_match_jax(runs):
    assert len(runs["tgrad"]) == len(runs["jgrad"]) > 20
    for k, g in runs["tgrad"].items():
        assert float(g.abs().max()) > 0, k     # every weight takes part
    _close_by_tensor(runs["tgrad"], runs["jgrad"], 1e-4)


def test_train_steps_match_jax(runs):
    for (tl, taux), (jl, jaux) in zip(runs["tsteps"], runs["jsteps"]):
        assert np.isfinite(tl) and tl == pytest.approx(jl, rel=1e-5)
        assert taux.keys() == jaux.keys()
        for k in jaux:
            assert taux[k] == pytest.approx(jaux[k], rel=1e-5), k
    reach = ADAM_REACH * sum(TT.learning_rate(runs["trainer"].cfg, STEPS_PER_EPOCH, k)
                             for k in range(STEPS))
    assert runs["trainer"].step == STEPS
    start = seeded_params(runs["trainer"].cfg, seed=3)
    diffs, moved = [], []
    for k, want in runs["jfinal"].items():
        d = np.abs(to_np(runs["tfinal"][k]) - want)
        assert float(d.max()) <= reach, (k, float(d.max()))
        diffs.append(d.ravel())
        moved.append(to_np((runs["tfinal"][k] - start[k]).abs()).ravel())
    diff, moved = float(np.median(np.concatenate(diffs))), float(np.median(np.concatenate(moved)))
    print(f"params: largest difference {max(float(d.max()) for d in diffs):.3e} (reach "
          f"{reach:.3e}), median {diff:.3e}; median move {moved:.3e}")
    assert diff <= 1e-6 and moved > 1e3 * diff


def test_eval_step_matches_jax(runs):
    assert runs["teval"].keys() == runs["jeval"].keys()
    want = {"discrete": {"accuracy"},
            "continuous": {"density_mse", "youngs_mse", "poisson_mse"}}[runs["mode"]]
    assert set(runs["teval"]) == want
    for k, v in runs["jeval"].items():
        assert runs["teval"][k] == pytest.approx(v, rel=1e-5), k


# -- checkpoints and the loop ----------------------------------------------------------

def _tiny_cfg(**kw):
    return TT.TrainConfig(**{**dict(batch_size=1, lr=1e-3, lr_decay_rate=0.5, **SMALL), **kw})


def test_checkpoint_round_trip_and_resume(tmp_path):
    """4 steps in one go equal 2 steps, epoch_0.pth, a fresh trainer
    loading it, and 2 more steps, bit for bit; the file is the reference's
    format, which the JAX package's converter reads."""
    from pixie_tpu.models.convert_torch import load_torch_checkpoint

    cfg = _tiny_cfg(mode="continuous")
    rng = np.random.default_rng(6)
    batches = [_mode_batch("continuous", *_batch(rng, b=1)) for _ in range(4)]
    whole = TT.Trainer(cfg, device="cpu")
    whole.setup(2)
    start = whole.params
    for b in batches:
        whole.train_step(b)

    first = TT.Trainer(cfg, device="cpu")
    first.setup(2, params=start)
    for b in batches[:2]:
        first.train_step(b)
    path = first.save_checkpoint(tmp_path / "ck", epoch=0)
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"model_state_dict", "optimizer_state_dict", "epoch", "step"}
    assert ckpt["epoch"] == 0 and ckpt["step"] == 2
    assert TT.latest_checkpoint(tmp_path / "ck").name == "epoch_0.pth"
    conv = load_torch_checkpoint(path, **ARCH)["params"]
    np.testing.assert_array_equal(
        state_dict_from_jax(conv, **ARCH)["unet.out.2.weight"],
        to_np(first.model.state_dict()["unet.out.2.weight"]))

    resumed = TT.Trainer(cfg, device="cpu")
    resumed.setup(2)
    resumed.load_checkpoint(path)
    assert resumed.epoch == 0 and resumed.step == 2
    for b in batches[2:]:
        resumed.train_step(b)
    for k, v in whole.model.state_dict().items():
        np.testing.assert_array_equal(to_np(resumed.model.state_dict()[k]), to_np(v), err_msg=k)
    for a, b in zip(whole.opt.state_dict()["state"].values(),
                    resumed.opt.state_dict()["state"].values()):
        np.testing.assert_array_equal(to_np(a["exp_avg_sq"]), to_np(b["exp_avg_sq"]))


def test_init_params_is_seeded_and_leaves_the_generator_alone():
    cfg = _tiny_cfg(mode="discrete")
    before = torch.random.get_rng_state()
    a = TT.Trainer(cfg, device="cpu").init_params()
    assert torch.equal(torch.random.get_rng_state(), before)
    b = TT.Trainer(cfg, device="cpu").init_params()
    c = TT.Trainer(cfg, device="cpu").init_params(rng_seed=1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    # the reference's zero_module output convs
    assert float(a["unet.out.2.weight"].abs().max()) == 0.0


def test_train_loop_end_to_end(tmp_path, monkeypatch):
    """JAX's loop structure: the split (seed 42) in train_test_splits.json,
    4 steps an epoch (4 training objects, batch 1), max_steps 6 cutting the
    run inside epoch 1 of 3 with save_interval 2: epoch_1.pth only,
    history.json with the epochs run, and the learning rate of every update
    JAX's schedule at the count of updates made."""
    import optax
    from test_training import make_fixture_dataset

    from pixie_tpu.train.data import MaterialVoxelDataset as JDataset
    from pixie_tpu.train.data import save_splits as j_save_splits
    from pixie_tpu.train.data import train_test_split as j_split
    from pixie_tpu_torch.train.data import MaterialVoxelDataset
    from pixie_tpu_torch.utils.norm import REFERENCE_RANGES

    root = make_fixture_dataset(tmp_path / "render_outputs", n_objects=5)
    ds = MaterialVoxelDataset(root, REFERENCE_RANGES, grid_size=D, feature_channels=12)
    cfg = _tiny_cfg(mode="discrete", batch_size=1, epochs=3, save_interval=2, train_size=0.8)
    lrs = []
    learning_rate = TT.learning_rate
    monkeypatch.setattr(TT, "learning_rate", lambda c, spe, k: lrs.append((spe, k)) or
                        learning_rate(c, spe, k))
    seen = []
    trainer, history = TT.train_loop(cfg, ds, tmp_path / "ck", max_steps=6, device="cpu",
                                     on_step=seen.append)
    assert [s["step"] for s in seen] == list(range(6))
    assert [s["epoch"] for s in seen] == [0, 0, 0, 0, 1, 1]
    assert all(np.isfinite(s["loss"]) and s["data_s"] >= 0 and s["step_s"] > 0 for s in seen)
    assert set(seen[0]) == {"step", "epoch", "loss", "accuracy", "data_s", "step_s"}
    assert trainer.step == 6 and lrs == [(4, k) for k in range(6)]
    sched = optax.exponential_decay(cfg.lr, 4, cfg.lr_decay_rate, staircase=True)
    assert trainer.opt.param_groups[0]["lr"] == pytest.approx(float(sched(5)), rel=1e-6)
    assert float(sched(5)) == pytest.approx(cfg.lr * cfg.lr_decay_rate)
    assert sorted(p.name for p in (tmp_path / "ck").glob("epoch_*")) == ["epoch_1.pth"]
    assert TT.latest_checkpoint(tmp_path / "ck").name == "epoch_1.pth"
    hist = json.loads((tmp_path / "ck" / "history.json").read_text())
    assert [h["epoch"] for h in hist] == [0, 1] and hist == history
    assert hist[0]["loss"] == pytest.approx(np.mean([s["loss"] for s in seen[:4]]))
    # the split file is JAX's, byte for byte
    jds = JDataset(root, REFERENCE_RANGES, grid_size=D, feature_channels=12)
    j_save_splits(tmp_path / "j.json", jds, *j_split(len(jds), 0.8, seed=42))
    assert (tmp_path / "ck" / "train_test_splits.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_train_loop_steps_are_the_trainers_steps(tmp_path):
    """train_loop's per-step losses equal a Trainer fed the same batches in
    the loop's order (JAX's rng.permutation per epoch, batches of the
    permuted split) as the dataset's float32 items; the loop reads the
    float16 features as stored and casts them in the trainer."""
    from test_training import make_fixture_dataset

    from pixie_tpu_torch.train.data import MaterialVoxelDataset, train_test_split
    from pixie_tpu_torch.utils.norm import REFERENCE_RANGES

    root = make_fixture_dataset(tmp_path / "render_outputs", n_objects=5)
    for f in root.glob("*/clip_features_features.npy"):   # as the voxelizer writes them
        np.save(f, np.load(f).astype(np.float16))
    ds = MaterialVoxelDataset(root, REFERENCE_RANGES, grid_size=D, feature_channels=12)
    cfg = _tiny_cfg(mode="continuous", batch_size=2, epochs=2, save_interval=100)
    seen = []
    trainer, _ = TT.train_loop(cfg, ds, tmp_path / "ck", device="cpu", on_step=seen.append)
    assert len(seen) == 4 and (tmp_path / "ck" / "epoch_1.pth").exists()

    ref = TT.Trainer(cfg, device="cpu")
    ref.setup(2)
    rng = np.random.default_rng(cfg.seed)
    train_idx, _ = train_test_split(len(ds), cfg.train_size, seed=42)
    losses = []
    for _ in range(cfg.epochs):
        for feat, cont, _, mask, _, _ in ds.batches(2, rng.permutation(train_idx),
                                                     drop_remainder=True):
            losses.append(ref.train_step((feat, cont, mask))[0])
    assert [s["loss"] for s in seen] == losses


def test_entry_points_default_to_cuda():
    from pixie_tpu_torch.train.inference import run_inference

    for fn in (TT.Trainer.__init__, TT.train_loop, run_inference):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# -- DDP -------------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_ddp_gradient_equals_one_process(tmp_path, world):
    """2 and 4 gloo processes (file:// rendezvous under tmp_path) on two
    global batches: 4 samples whose halves hold different foreground
    counts, and 3 samples (padded to 4 with a zero-weight copy of the last;
    with 4 ranks, one rank holds the pad alone).  Each rank's averaged
    gradient equals one process's gradient on the whole batch, and the loss
    is the whole batch's."""
    cfg_kw = dict(mode="discrete", batch_size=4, **SMALL)
    params = seeded_params(TT.TrainConfig(**cfg_kw), seed=8)
    batch_paths, batches = ddp_batches(tmp_path, np.random.default_rng(9))
    assert (batches[0][1][:2] != 7).sum() * 3 < (batches[0][1][2:] != 7).sum()
    ranks = run_ddp(tmp_path, world, cfg_kw, params, batch_paths)

    for i, (feat, mat_id, mask) in enumerate(batches):
        one = TT.Trainer(TT.TrainConfig(**cfg_kw), device="cpu")
        one.setup(1, params=params)
        loss, aux = one.train_step((feat, mat_id, mask))
        want = {n: p.grad for n, p in one.model.named_parameters()}
        for r in ranks:
            assert r[i]["world"] == world
            assert r[i]["loss"] == pytest.approx(loss, rel=1e-5)
            worst = _close_by_tensor(r[i]["grads"], {k: to_np(v) for k, v in want.items()},
                                     1e-4)
            print(f"DDP over {world}, batch of {len(feat)}: worst gradient error {worst:.3e}")
        for k in want:   # DDP's average is the same tensor on every rank
            for r in ranks[1:]:
                torch.testing.assert_close(r[i]["grads"][k], ranks[0][i]["grads"][k],
                                           rtol=0, atol=0)
        # JAX's in-step accuracy counts the zero-weight pad row (mask=None)
        rows = [0, 1, 2, 2] if len(feat) == 3 else [0, 1, 2, 3]
        start = TT.Trainer(TT.TrainConfig(**cfg_kw), device="cpu")
        start.setup(1, params=params)
        with torch.no_grad():
            out = start.model(torch.as_tensor(feat[rows]))
        acc = TM.compute_accuracy(out.movedim(-1, 1), torch.as_tensor(mat_id[rows]),
                                  ignore_index=7)
        for r in ranks:
            assert r[i]["aux"]["accuracy"] == pytest.approx(float(acc), rel=1e-6)
        if len(feat) == 4:
            # a plain DDP wrap averages the gradients of the halves' own
            # masked means: far off on this batch
            start.model.zero_grad()
            halves = [TT.discrete_loss(start.model(torch.as_tensor(feat[h])),
                                       torch.as_tensor(mat_id[h]), None, 7)
                      for h in (slice(0, 2), slice(2, 4))]
            (0.5 * (halves[0] + halves[1])).backward()
            plain = {n: p.grad for n, p in start.model.named_parameters()}
            with pytest.raises(AssertionError):
                _close_by_tensor(plain, {k: to_np(v) for k, v in want.items()}, 1e-1)
