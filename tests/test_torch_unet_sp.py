"""The U-Net trainer with each sample's D axis split over an ``sp`` group
(``Trainer(cfg, device, mesh=get_mesh(dp, sp))``, models/unet3d.py's
``DepthHalo``, sharded norms and attention) on 2 and 4 gloo processes,
against one process of the port and against JAX's Trainer on a (dp 1,
sp 2) mesh of the virtual devices of tests/conftest.py.

Sizes are the multi-device dry run's (__graft_entry__.py:94-97: features
16, cond 8, channels 8, one res block, mult (1, 2), grid 8).  Bounds are
the DDP test's (tests/test_torch_unet_train.py): the loss to rel 1e-5, each
gradient within 1e-4 of its tensor's largest |value| (or of 1e-3 of the
net's largest where that is larger).  Unlike DDP's, the sharded forward
rounds otherwise than one process (the norms' sums), and a LeakyReLU input
within rounding of 0 then takes the other slope: one process's own float32
gradient then misses its float64 one by up to a few percent of a small
tensor (1 batch in 8 here).  Such a tensor is held to its float64 gradient
within twice one process's float32 error.  The sharded nets themselves are
held to one process in float64 to 1e-9, where no slope flips.  The halo
Function's Jacobian is checked in float64 both ways (central differences,
and backward rows).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_dist_workers import (
    check_sp_grads, load_batches, run_ranks, unet64_case, unet_grads64, unet_steps,
)
from torch_parity import to_np
from unet_train_parity import seeded_params

from pixie_tpu.models.convert_torch import convert_state_dict
from pixie_tpu.parallel.mesh import get_mesh as jax_mesh
from pixie_tpu.train import trainer as JT

from pixie_tpu_torch.models import unet3d as TU
from pixie_tpu_torch.train import trainer as TT

DRY = dict(feature_channels=16, cond_dim=8, model_channels=8, num_res_blocks=1,
           channel_mult=(1, 2), grid_size=8)
ARCH = dict(num_res_blocks=1, channel_mult=(1, 2))
GRAD_FLOOR = 1e-3


def _save_batches(tmp_path, tag, rng, mode, sizes):
    """Batches whose rows hold different foreground shares."""
    d, fc = DRY["grid_size"], DRY["feature_channels"]
    paths = []
    for i, b in enumerate(sizes):
        feat = rng.normal(size=(b, d, d, d, fc)).astype(np.float32)
        mask = (rng.uniform(size=(b, d, d, d)) < rng.uniform(0.1, 0.8, (b, 1, 1, 1))
                ).astype(np.float32)
        if mode == "discrete":
            target = np.where(mask > 0, rng.integers(0, 7, mask.shape), 7).astype(np.int64)
        else:
            target = rng.uniform(0, 1, (b, d, d, d, 3)).astype(np.float32)
        path = tmp_path / f"{tag}_{i}.npz"
        np.savez(path, feat=feat, target=target, mask=mask)
        paths.append(str(path))
    return paths


# name -> (dp, sp, mode, batch sizes, extra config)
RUNS = {
    "sp2_discrete": (1, 2, "discrete", (2, 2, 1), {}),
    "sp2_continuous": (1, 2, "continuous", (2, 1, 2), {}),
    "sp2_attention": (1, 2, "discrete", (2, 2), {"attention_resolutions": (1, 2)}),
    "dp2sp2_discrete": (2, 2, "discrete", (4, 3), {}),
    "dp2sp2_continuous": (2, 2, "continuous", (3, 4), {}),
}


def _cfg_kw(name):
    dp, sp, mode, sizes, extra = RUNS[name]
    return dict(mode=mode, batch_size=max(sizes), lr=1e-3, **DRY, **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each run's per-rank steps (one start of 2 and one of 4 ranks) and
    one process's steps from the same weights and batches."""
    tmp = tmp_path_factory.mktemp("unet_sp")
    rng = np.random.default_rng(21)
    specs = {}
    for i, (name, (dp, sp, mode, sizes, _)) in enumerate(RUNS.items()):
        params = seeded_params(TT.TrainConfig(**_cfg_kw(name)), seed=30 + i)
        torch.save(params, tmp / f"{name}.pt")
        specs[name] = dict(dp=dp, sp=sp, cfg=_cfg_kw(name), params=str(tmp / f"{name}.pt"),
                           batches=_save_batches(tmp, name, rng, mode, sizes))
    out = {}
    for world in (2, 4):
        names = [k for k, (dp, sp, *_) in RUNS.items() if dp * sp == world]
        res = run_ranks(tmp, world, "unet", {"runs": [specs[k] for k in names]})
        for i, k in enumerate(names):
            out[k] = dict(ranks=[r[i] for r in res], spec=specs[k], one=unet_steps(
                lambda k=k: _one_process(specs[k]), load_batches(specs[k]["batches"])))
    return out


def _one_process(spec):
    one = TT.Trainer(TT.TrainConfig(**spec["cfg"]), device="cpu")
    one.setup(1, params=torch.load(spec["params"]))
    return one


def _close_by_tensor(got: dict, want: dict, rtol: float) -> float:
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        scale = max(float(w.abs().max()), GRAD_FLOOR * top)
        err = float((got[k] - w).abs().max()) / scale
        assert err <= rtol, (k, err)
        worst = max(worst, err)
    return worst


def _padded(batch, dp):
    """The rows a (dp, sp) trainer steps on: the batch padded to a multiple
    of dp with its last row (the JAX trainer's in-step metrics count it)."""
    pad = (-len(batch[0])) % dp
    return tuple(np.concatenate([x] + [x[-1:]] * pad) for x in batch)


@pytest.mark.parametrize("name", list(RUNS))
def test_sp_steps_match_one_process(runs, name):
    """Each batch's step (from the same weights) on every rank against one
    process on the whole batch: the loss, the metrics (one process on the
    padded rows), the gradients."""
    r = runs[name]
    spec = r["spec"]
    for step, (want, batch) in enumerate(zip(r["one"], load_batches(spec["batches"]))):
        aux = _one_process(spec).train_step(_padded(batch, spec["dp"]))[1]
        want64 = unet_grads64(spec["cfg"], torch.load(spec["params"]), batch)
        for rank in r["ranks"]:
            got = rank[step]
            assert np.isfinite(got["loss"])
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
            for k, v in aux.items():
                assert got["aux"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
            worst = check_sp_grads(got["grads"], want["grads"], want64, 1e-4, GRAD_FLOOR)
            print(f"{name} step {step}: worst gradient error {worst:.3e}")


@pytest.fixture(scope="module")
def nets64(tmp_path_factory):
    """The shipped block structure at the dry run's widths in float64 on 2
    and 4 slabs (with and without attention at both levels), against one
    process: the output slabs and the gradients summed over the slabs."""
    tmp = tmp_path_factory.mktemp("unet64")
    rng = np.random.default_rng(3)
    cases, want = [], []
    for i, (mode, extra) in enumerate((("discrete", {}),
                                       ("continuous", {"attention_resolutions": (1, 2)}))):
        cfg = dict(mode=mode, **DRY, **extra)
        params = seeded_params(TT.TrainConfig(**cfg), seed=40 + i)
        torch.save(params, tmp / f"p{i}.pt")
        d = DRY["grid_size"]
        feat = rng.normal(size=(2, d, d, d, DRY["feature_channels"]))
        out_ch = 8 if mode == "discrete" else 3
        cot = rng.normal(size=(2, d, d, d, out_ch))
        np.savez(tmp / f"d{i}.npz", feat=feat, cot=cot)
        cases.append(dict(cfg=cfg, params=str(tmp / f"p{i}.pt"), data=str(tmp / f"d{i}.npz")))
        want.append(unet64_case(cfg, params, feat, cot))
    return want, {w: run_ranks(tmp, w, "unet64", {"cases": cases}) for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_sp_nets_float64(nets64, world):
    want, got = nets64
    for i, (out, grads) in enumerate(want):
        y = torch.cat([r[i]["out"] for r in got[world]], 1)
        torch.testing.assert_close(y, out, rtol=0, atol=1e-9 * float(out.abs().max()))
        top = max(float(g.abs().max()) for g in grads.values())
        for r in got[world]:
            for k, g in grads.items():
                err = float((r[i]["grads"][k] - g).abs().max())
                assert err <= 1e-9 * max(float(g.abs().max()), GRAD_FLOOR * top), (k, err)


def test_sp_weights_take_part(runs):
    """Every gradient is non-zero on the sp run, and the slab-sliced norm
    weights got their whole gradient through DDP's sum over the slabs."""
    got = runs["sp2_discrete"]["ranks"][0][0]["grads"]
    for k, g in got.items():
        assert float(g.abs().max()) > 0, k
    assert any(k.endswith("in_layers.0.weight") and g.dim() == 3 for k, g in got.items())


def test_precondition_raises():
    """grid_size / (sp 2^(levels-1)) must be a whole number >= 1."""
    TU.check_spatial_split(64, 4, 2)
    TU.check_spatial_split(8, 2, 4)
    for grid, levels, sp in ((8, 2, 3), (8, 3, 4), (64, 4, 16), (6, 2, 2)):
        with pytest.raises(ValueError, match="does not split"):
            TU.check_spatial_split(grid, levels, sp)


@pytest.mark.parametrize("lo,hi", [(1, 1), (1, 0)])
def test_depth_halo_jacobian_float64(tmp_path, lo, hi):
    """DepthHalo on 2 ranks in float64 (the 3^3 convolution's halos, and
    the stride-2 one's): the Jacobian by central differences equals the one
    its backward gives, row by row, and the forward is the slabs' planes."""
    res = run_ranks(tmp_path, 2, "halo_jacobian", {"lo": lo, "hi": hi, "shape": (1, 2, 2, 2, 2)})
    for r in res:
        torch.testing.assert_close(r["analytical"], r["numerical"], rtol=0, atol=1e-8)
        assert int((r["analytical"] != 0).sum()) > 0
    x = [torch.randn((1, 2, 2, 2, 2), generator=torch.Generator().manual_seed(i),
                     dtype=torch.float64) for i in range(2)]
    zero = torch.zeros((1, 2, 1, 2, 2), dtype=torch.float64)
    want = [torch.cat([zero[:, :, :lo], x[0], x[1][:, :, :hi]], 2),
            torch.cat([x[0][:, :, 2 - lo:], x[1], zero[:, :, :hi]], 2)]
    torch.testing.assert_close(res[0]["out"], torch.cat(want, 2).reshape(-1), rtol=0, atol=0)


def test_sp_step_matches_jax_trainer(runs):
    """The sp 2 run's first step against JAX's Trainer on a (dp 1, sp 2)
    mesh of two virtual devices (GSPMD halo convolutions) from the same
    weights: the loss and the accuracy."""
    r = runs["sp2_discrete"]
    cfg_kw = r["spec"]["cfg"]
    sd = torch.load(r["spec"]["params"])
    jtr = JT.Trainer(JT.TrainConfig(**cfg_kw), mesh=jax_mesh(dp=1, sp=2,
                                                            devices=jax.devices()[:2]))
    jtr.setup(1, params=convert_state_dict(sd, **ARCH)["params"])
    batch = load_batches(r["spec"]["batches"])[0]
    loss, aux = jtr.train_step(batch)
    got = r["ranks"][0][0]
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    assert got["aux"]["accuracy"] == pytest.approx(float(aux["accuracy"]), rel=1e-5)
