"""JAX (flax) U-Net params -> reference torch state_dict.

The inverse of pixie_tpu/models/convert_torch.py:convert_state_dict, in pure
numpy: ``state_dict_from_jax(p)`` loads into
``pixie_tpu_torch.models.unet3d.SegmentationUNet``/``RegressionUNet`` and
``convert_state_dict(state_dict_from_jax(p)) == p``.

Layout conversions (the inverse of convert_torch.py's):
  * flax conv kernel (kD, kH, kW, I, O) -> Conv3d weight (O, I, kD, kH, kW)
  * flax Dense kernel (I, O)            -> Conv1d weight (O, I, 1)
  * flax GroupNorm scale                -> GroupNorm weight
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def _conv_w(k) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2)))


def _conv1d_w(k) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k).T[:, :, None])


def _put_conv(sd, prefix, p, conv1d=False):
    sd[f"{prefix}.weight"] = _conv1d_w(p["kernel"]) if conv1d else _conv_w(p["kernel"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _put_norm(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"] if "scale" in p else p["weight"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _put_resblock(sd, prefix, p):
    _put_norm(sd, f"{prefix}.in_layers.0", p["in_norm"])
    _put_conv(sd, f"{prefix}.in_layers.2", p["in_conv"])
    _put_norm(sd, f"{prefix}.out_layers.0", p["out_norm"])
    _put_conv(sd, f"{prefix}.out_layers.3", p["out_conv"])
    if "skip_conv" in p:
        _put_conv(sd, f"{prefix}.skip_connection", p["skip_conv"])


def _put_attention(sd, prefix, p):
    _put_norm(sd, f"{prefix}.norm", p["norm"])
    _put_conv(sd, f"{prefix}.qkv", p["qkv"], conv1d=True)
    _put_conv(sd, f"{prefix}.proj_out", p["proj_out"], conv1d=True)


def state_dict_from_jax(
    flax_params: Mapping,
    num_res_blocks: int = 3,
    channel_mult: Sequence[int] = (1, 1, 2, 4),
    attention_resolutions: Sequence[int] = (),
) -> dict[str, np.ndarray]:
    """flax params (``{"params": ...}`` or the inner dict, leaves as numpy)
    of a SegmentationUNet / RegressionUNet -> torch state_dict (numpy)."""
    params = flax_params.get("params", flax_params)
    sd: dict[str, np.ndarray] = {}

    if "projector" in params:
        pr = params["projector"]
        _put_conv(sd, "projector.net.0", pr["conv0"])
        _put_norm(sd, "projector.net.1", pr["gn0"])
        if "conv1" in pr:
            _put_conv(sd, "projector.net.3", pr["conv1"])
            _put_norm(sd, "projector.net.4", pr["gn1"])
            _put_conv(sd, "projector.net.6", pr["conv2"])
            _put_norm(sd, "projector.net.7", pr["gn2"])

    u = params["unet"]
    _put_conv(sd, "unet.input_blocks.0.0", u["conv_in"])
    torch_idx, block, ds = 1, 0, 1
    for level, _ in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            _put_resblock(sd, f"unet.input_blocks.{torch_idx}.0", u[f"down_{block}"])
            if ds in attention_resolutions:
                _put_attention(sd, f"unet.input_blocks.{torch_idx}.1",
                               u[f"down_attn_{block}"])
            torch_idx += 1
            block += 1
        if level != len(channel_mult) - 1:
            _put_conv(sd, f"unet.input_blocks.{torch_idx}.0.op",
                      u[f"downsample_{level}"]["op"])
            torch_idx += 1
            ds *= 2

    _put_resblock(sd, "unet.middle_block.0", u["middle_0"])
    _put_attention(sd, "unet.middle_block.1", u["middle_attn"])
    _put_resblock(sd, "unet.middle_block.2", u["middle_2"])

    block = 0
    for level, _ in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            prefix = f"unet.output_blocks.{block}"
            _put_resblock(sd, f"{prefix}.0", u[f"up_{block}"])
            layer = 1
            if ds in attention_resolutions:
                _put_attention(sd, f"{prefix}.{layer}", u[f"up_attn_{block}"])
                layer += 1
            if level and i == num_res_blocks:
                _put_conv(sd, f"{prefix}.{layer}.conv", u[f"upsample_{block}"]["conv"])
                ds //= 2
            block += 1

    _put_norm(sd, "unet.out.0", u["out_norm"])
    _put_conv(sd, "unet.out.2", u["out_conv"])
    return sd
