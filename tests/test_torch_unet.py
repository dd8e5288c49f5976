"""pixie_tpu_torch U-Nets vs pixie_tpu.models.unet3d (float32, CPU).

Sizes as tests/test_unet_parity.py:60-66.  The torch nets get seeded random
non-zero weights (zero-init convs included); the JAX nets get the same
weights through pixie_tpu's own checkpoint converter, so the test also holds
the port's state_dict keys to the released checkpoint keys.  Tolerance
atol 2e-4 / rtol 1e-3 as the JAX package's own torch parity test; class maps
must agree wherever the JAX top-2 logit margin is at least 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import to_np

from pixie_tpu.models.convert_torch import convert_state_dict
from pixie_tpu.models.unet3d import RegressionUNet as JReg
from pixie_tpu.models.unet3d import SegmentationUNet as JSeg
from pixie_tpu_torch.models.convert import state_dict_from_jax
from pixie_tpu_torch.models.unet3d import RegressionUNet, SegmentationUNet, seeded_state_dict

CASES = [(16, (1, 2), 1, 48), (16, (1, 1, 2), 2, 48)]


def _pair(head, grid, mult, res_blocks, fc, seed=0):
    kw = dict(feature_channels=fc, cond_dim=32, model_channels=16,
              num_res_blocks=res_blocks, channel_mult=mult, grid_size=grid)
    if head == "seg":
        tmodel, jmodel = SegmentationUNet(num_classes=8, **kw), JSeg(num_classes=8, **kw)
    else:
        tmodel, jmodel = RegressionUNet(out_channels=3, **kw), JReg(out_channels=3, **kw)
    tmodel.load_state_dict(seeded_state_dict(tmodel, seed))
    tmodel.eval()
    params = convert_state_dict(tmodel.state_dict(), num_res_blocks=res_blocks,
                                channel_mult=mult)
    return tmodel, jmodel, params


@pytest.mark.parametrize("head", ["seg", "reg"])
@pytest.mark.parametrize("grid,mult,res_blocks,fc", CASES)
def test_forward_matches_jax(head, grid, mult, res_blocks, fc):
    tmodel, jmodel, params = _pair(head, grid, mult, res_blocks, fc)
    x = np.random.default_rng(1).normal(size=(2, grid, grid, grid, fc)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, x))
    with torch.no_grad():
        got = to_np(tmodel(torch.as_tensor(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    if head == "seg":
        top2 = np.sort(want, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) >= 1e-4
        assert decided.mean() > 0.99
        np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


@pytest.mark.parametrize("grid,mult,res_blocks,fc", CASES)
def test_converter_round_trip(grid, mult, res_blocks, fc):
    _, _, params = _pair("seg", grid, mult, res_blocks, fc, seed=3)
    sd = state_dict_from_jax(params, res_blocks, mult)
    back = convert_state_dict(sd, num_res_blocks=res_blocks, channel_mult=mult)
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_p, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(k))
    # and the state_dict loads into the port with exactly its keys
    tmodel = SegmentationUNet(num_classes=8, feature_channels=fc, cond_dim=32,
                              model_channels=16, num_res_blocks=res_blocks,
                              channel_mult=mult, grid_size=grid)
    assert set(sd) == set(tmodel.state_dict())
    tmodel.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})


def test_combined_inference_from_pth(tmp_path):
    from pixie_tpu_torch.train.inference import CombinedInference, load_params

    kw = dict(feature_channels=48, cond_dim=32, model_channels=16, num_res_blocks=1,
              channel_mult=(1, 2), grid_size=16)
    seg = SegmentationUNet(num_classes=8, **kw)
    reg = RegressionUNet(out_channels=3, **kw)
    for i, (m, name) in enumerate(((seg, "seg"), (reg, "reg"))):
        m.load_state_dict(seeded_state_dict(m, 10 + i))
        # DDP-style prefixes are stripped by load_params
        torch.save({"model_state_dict": {f"module.{k}": v for k, v in m.state_dict().items()}},
                   tmp_path / f"{name}_epoch_1.pth")
    model_kwargs = {k: kw[k] for k in ("cond_dim", "model_channels", "num_res_blocks",
                                       "channel_mult")}
    infer = CombinedInference(load_params(tmp_path / "seg_epoch_1.pth"),
                              load_params(tmp_path / "reg_epoch_1.pth"), grid_size=16,
                              feature_channels=48, model_kwargs=model_kwargs, device="cpu")
    x = np.random.default_rng(0).normal(size=(16, 16, 16, 48)).astype(np.float16)
    s, c = infer.predict_device(torch.as_tensor(x))
    seg.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(to_np(s), to_np(seg(torch.as_tensor(x, dtype=torch.float32)[None])[0]))
    pred = infer.combined_prediction(s, c)
    assert pred.shape == (11, 16, 16, 16)
    np.testing.assert_array_equal(pred[3:].sum(0), 1.0)
    np.testing.assert_array_equal(pred[3:].argmax(0), to_np(s).argmax(-1))
