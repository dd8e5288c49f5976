"""Traffic driver: the neural material stage, one object at a time.

Set-up makes both nets' weights and a pool of feature grids on the device
from the seed, hands the weights to the port's ``CombinedInference`` and
warms the stage.  Each unit of the window is one object: a grid of the
pool (cycled) through ``CombinedInference.predict_device`` (both nets),
``combined_prediction`` (the host's argmax and one-hot) and
``utils.norm.unscale_prediction``, what ``infer_single_device`` and
``map_pred_to_ply`` compute, without their file writes.

``check`` runs ``reference/unet.py`` once over each grid of the pool and
judges every object the window produced: the widest gap by which the
reference's logit of the program's class lies below the reference's best,
and the widest relative gap of the unscaled density, E and nu.

``FAULTS`` plant faults in the window's objects (``control.py --what
fault:<name>``, and the CPU tests): each returns a context manager.
"""

from __future__ import annotations

import math
from unittest import mock

import torch

from benchmark.reference import unet as ref


def make_weights(cfg: dict, out_channels: int, gen, device) -> dict:
    """One net's state dict, drawn in one call: conv weights N(0, 1/fan_in),
    biases N(0, 0.05^2), norm scales 1 + N(0, 0.1^2), norm shifts
    N(0, 0.1^2)."""
    specs = ref.param_specs(cfg, out_channels)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        k = math.prod(shape)
        a = flat[at:at + k].view(shape)
        at += k
        if kind == "conv":
            a = a / math.sqrt(math.prod(shape[1:]))
        elif kind == "norm_w":
            a = 1.0 + 0.1 * a
        elif kind == "norm_b":
            a = 0.1 * a
        else:
            a = 0.05 * a
        out[name] = a.contiguous()
    return out


class Cell:
    work_name = "grids"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from pixie_tpu_torch.train.inference import CombinedInference
        from pixie_tpu_torch.utils.norm import NormalizationRanges, unscale_prediction

        self.cfg, self.device = cfg, torch.device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self.seg_p = make_weights(cfg, cfg["num_classes"], gen, self.device)
        self.cont_p = make_weights(cfg, cfg["cont_channels"], gen, self.device)
        side, fc = cfg["grid_size"], cfg["feature_channels"]
        dtype = getattr(torch, cfg["feature_dtype"])
        self.pool = [torch.randn((side, side, side, fc), generator=gen, device=self.device,
                                 dtype=dtype) for _ in range(int(traffic["pool"]))]
        self.infer = CombinedInference(
            self.seg_p, self.cont_p, grid_size=side, feature_channels=fc,
            num_classes=cfg["num_classes"], background_id=cfg["background_id"],
            model_kwargs=dict(cond_dim=cfg["cond_dim"], model_channels=cfg["model_channels"],
                              num_res_blocks=cfg["num_res_blocks"],
                              channel_mult=tuple(cfg["channel_mult"]),
                              attention_resolutions=tuple(cfg["attention_resolutions"])),
            device=self.device)
        self.ranges = NormalizationRanges.from_dict(cfg["normalization_ranges"])
        self._unscale = unscale_prediction
        self.outputs: list = []        # (pool index, unscaled prediction) of each window unit
        self.units = 0
        for _ in range(int(traffic["warm_units"])):
            self._object(0)

    def _object(self, k: int):
        seg, cont = self.infer.predict_device(self.pool[k])
        return self._unscale(self.infer.combined_prediction(seg, cont), self.ranges)

    def step(self) -> int:
        """One object (its outputs are on the host when it returns)."""
        k = self.units % len(self.pool)
        self.outputs.append((k, self._object(k)))
        self.units += 1
        return 1

    def check(self, control: str | None = None) -> dict:
        """Gaps between the program's objects and the reference (see the
        module's docstring); frees the program's nets first.  With
        ``control`` ("tf32"), the reference with TF32 convolutions stands in
        the program's place, once for each grid of the pool."""
        self.infer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        k_cls = self.cfg["cont_channels"]
        class_gap = cont_gap = 0.0
        for p in sorted({k for k, _ in self.outputs}):
            logits, cont = ref.material_stage(self.seg_p, self.cont_p, self.pool[p], self.cfg,
                                              tf32=False)
            best = logits.max(-1).values
            preds = [torch.as_tensor(pred, device=self.device)
                     for k, pred in self.outputs if k == p]
            if control == "tf32":
                c_logits, c_cont = ref.material_stage(self.seg_p, self.cont_p, self.pool[p],
                                                      self.cfg, tf32=True)
                preds = [torch.cat([c_cont.permute(3, 0, 1, 2),
                                    torch.nn.functional.one_hot(c_logits.argmax(-1),
                                                                self.cfg["num_classes"])
                                    .permute(3, 0, 1, 2)]).to(torch.float64)]
            elif control is not None:
                raise ValueError(f"unknown control {control!r}")
            for pred in preds:
                cls = pred[k_cls:].argmax(0)
                class_gap = max(class_gap, float(
                    (best - logits.gather(-1, cls[..., None])[..., 0]).max()))
                got = pred[:k_cls].permute(1, 2, 3, 0).to(torch.float64)
                cont_gap = max(cont_gap, float(((got - cont).abs() / cont.abs()).max()))
        return {"class_gap": class_gap, "cont_gap": cont_gap}


# -- faults planted in the window's objects ------------------------------------------------

def _stale_object(cell):
    """Every object gets the nets' outputs of the window's first object."""
    real = cell.infer.predict_device
    first = []

    def stale(feat):
        if not first:
            first.append(real(feat))
        return first[0]

    return mock.patch.object(cell.infer, "predict_device", stale)


def _half_grid(cell):
    """The nets' outputs of half the grid (its upper half along x) are
    those of the lower half."""
    real = cell.infer.predict_device

    def half(feat):
        seg, cont = real(feat)
        d = seg.shape[0] // 2
        return torch.cat([seg[:d], seg[:d]]), torch.cat([cont[:d], cont[:d]])

    return mock.patch.object(cell.infer, "predict_device", half)


def _class_flipped(cell):
    """One voxel's class is the next one over, where the one-hot is made."""
    real = cell.infer.combined_prediction
    k_cls = cell.cfg["cont_channels"]

    def flipped(seg, cont):
        out = real(seg, cont)
        k = int(out[k_cls:, 1, 2, 3].argmax())
        out[k_cls + k, 1, 2, 3], out[k_cls + (k + 1) % cell.cfg["num_classes"], 1, 2, 3] = 0, 1
        return out

    return mock.patch.object(cell.infer, "combined_prediction", flipped)


FAULTS = {"state_unchanged": _stale_object, "half_left_out": _half_grid,
          "answer_altered": _class_flipped}
