"""Plain reference of the material stage that ``tree_neural.material`` times:
the segmentation and regression U-Nets over one feature grid, the class
argmax and the unscaled continuous channels.

Written from the published architecture (Wavelet-Generation's
diffusion_network.py as PIXIE trains it: a feature projector, then a U-Net
of LayerNorm-LeakyReLU-conv residual blocks over channel_mult levels,
stride-2 downsampling, nearest upsampling, one attention block in the
middle), as functions of a state dict keyed as the released ``epoch_*.pth``
checkpoints.  Plain PyTorch (``torch.nn.functional``); it imports nothing
of the program.  ``tf32`` picks the convolutions' precision: False is the
reference, True the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def param_specs(cfg: dict, out_channels: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter of one net, in the checkpoint's
    key order; kind is "conv", "bias", "norm_w" or "norm_b"."""
    specs: list[tuple[str, tuple, str]] = []

    def conv(name, cin, cout, k, dims=3):
        specs.append((f"{name}.weight", (cout, cin) + (k,) * dims, "conv"))
        specs.append((f"{name}.bias", (cout,), "bias"))

    def norm(name, shape):
        specs.append((f"{name}.weight", shape, "norm_w"))
        specs.append((f"{name}.bias", shape, "norm_b"))

    def res(name, cin, cout, sp):
        norm(f"{name}.in_layers.0", (sp, sp, sp))
        conv(f"{name}.in_layers.2", cin, cout, 3)
        norm(f"{name}.out_layers.0", (sp, sp, sp))
        conv(f"{name}.out_layers.3", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.skip_connection", cin, cout, 1)

    def attn(name, c):
        norm(f"{name}.norm", (c,))
        conv(f"{name}.qkv", c, 3 * c, 1, dims=1)
        conv(f"{name}.proj_out", c, c, 1, dims=1)

    fc, cd, mc = cfg["feature_channels"], cfg["cond_dim"], cfg["model_channels"]
    mult, nrb, attn_res = cfg["channel_mult"], cfg["num_res_blocks"], cfg["attention_resolutions"]
    if fc != cd:
        if fc > cd:
            hid = 128
            conv("projector.net.0", fc, hid, 1)
            norm("projector.net.1", (hid,))
            conv("projector.net.3", hid, hid, 3)
            norm("projector.net.4", (hid,))
            conv("projector.net.6", hid, cd, 1)
            norm("projector.net.7", (cd,))
        else:
            conv("projector.net.0", fc, cd, 1)
            norm("projector.net.1", (cd,))
    for kind, name, args in _layout(cfg, out_channels):
        if kind == "conv":
            conv(f"unet.{name}", *args)
        elif kind == "res":
            res(f"unet.{name}", *args)
        elif kind == "attn":
            attn(f"unet.{name}", *args)
        elif kind == "norm":
            norm(f"unet.{name}", *args)
    return specs


def _layout(cfg: dict, out_channels: int):
    """The U-Net's blocks in order: (kind, name, args)."""
    mc, mult, nrb = cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    attn_res = cfg["attention_resolutions"]
    sp = cfg["grid_size"]
    out = [("conv", "input_blocks.0.0", (cfg["cond_dim"], mc, 3))]
    chans, ch, ds, sizes, i = [mc], mc, 1, [sp], 1
    for level, m in enumerate(mult):
        for _ in range(nrb):
            out.append(("res", f"input_blocks.{i}.0", (ch, m * mc, sp)))
            ch = m * mc
            if ds in attn_res:
                out.append(("attn", f"input_blocks.{i}.1", (ch,)))
            chans.append(ch)
            i += 1
        if level != len(mult) - 1:
            out.append(("down", f"input_blocks.{i}.0.op", (ch, ch, 3)))
            chans.append(ch)
            sizes.append(sp)
            ds, sp, i = ds * 2, (sp + 1) // 2, i + 1
    out += [("res", "middle_block.0", (ch, ch, sp)), ("attn", "middle_block.1", (ch,)),
            ("res", "middle_block.2", (ch, ch, sp))]
    i = 0
    for level, m in list(enumerate(mult))[::-1]:
        for j in range(nrb + 1):
            out.append(("res", f"output_blocks.{i}.0", (ch + chans.pop(), mc * m, sp)))
            ch, k = mc * m, 1
            if ds in attn_res:
                out.append(("attn", f"output_blocks.{i}.1", (ch,)))
                k = 2
            if level and j == nrb:
                out.append(("up", f"output_blocks.{i}.{k}.conv", (ch, ch, 3)))
                ds, sp = ds // 2, sizes.pop()
            i += 1
    out += [("norm", "out.0", ((sp, sp, sp),)), ("conv", "out.2", (ch, out_channels, 3))]
    # down/up convs are plain convs in the state dict
    return [("conv", n, a) if k in ("down", "up") else (k, n, a) for k, n, a in out]


def _conv(x, p, name, stride=1):
    w = p[f"{name}.weight"]
    return F.conv3d(x, w, p[f"{name}.bias"], stride=stride, padding=w.shape[-1] // 2)


def _ln(x, p, name):
    w = p[f"{name}.weight"]
    return F.layer_norm(x, w.shape, w, p[f"{name}.bias"], 1e-5)


def _res(x, p, name):
    h = _conv(F.leaky_relu(_ln(x, p, f"{name}.in_layers.0"), 0.02), p, f"{name}.in_layers.2")
    h = _conv(F.leaky_relu(_ln(h, p, f"{name}.out_layers.0"), 0.02), p, f"{name}.out_layers.3")
    skip = _conv(x, p, f"{name}.skip_connection") if f"{name}.skip_connection.weight" in p else x
    return skip + h


def _attn(x, p, name):
    b, c = x.shape[:2]
    flat = x.reshape(b, c, -1)
    h = F.group_norm(flat, min(32, c), p[f"{name}.norm.weight"], p[f"{name}.norm.bias"], 1e-5)
    q, k, v = F.conv1d(h, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"]).split(c, 1)
    scale = 1.0 / math.sqrt(math.sqrt(c))
    w = torch.softmax(torch.einsum("bct,bcs->bts", q * scale, k * scale), dim=-1)
    a = torch.einsum("bts,bcs->bct", w, v)
    return (flat + F.conv1d(a, p[f"{name}.proj_out.weight"],
                            p[f"{name}.proj_out.bias"])).reshape(x.shape)


def net_forward(p: dict, feat: torch.Tensor, cfg: dict, out_channels: int) -> torch.Tensor:
    """One net: feat (D, H, W, C) of any float dtype -> (D, H, W, out) float32."""
    x = feat.to(torch.float32).permute(3, 0, 1, 2)[None]
    if "projector.net.0.weight" in p:
        x = _conv(x, p, "projector.net.0")
        if "projector.net.3.weight" in p:
            hid = x.shape[1]
            x = F.silu(F.group_norm(x, min(32, hid), p["projector.net.1.weight"],
                                    p["projector.net.1.bias"], 1e-5))
            x = _conv(x, p, "projector.net.3")
            x = F.silu(F.group_norm(x, min(32, hid), p["projector.net.4.weight"],
                                    p["projector.net.4.bias"], 1e-5))
            x = _conv(x, p, "projector.net.6")
            x = F.group_norm(x, min(32, x.shape[1]), p["projector.net.7.weight"],
                             p["projector.net.7.bias"], 1e-5)
        else:
            x = F.silu(F.group_norm(x, max(x.shape[1] // 2, 1), p["projector.net.1.weight"],
                                    p["projector.net.1.bias"], 1e-5))
    hs, h = [], x
    layout = _layout(cfg, out_channels)
    n_in = sum(1 for _, n, _ in layout if n.startswith("input_blocks"))
    for kind, name, _ in layout[:n_in]:
        if kind == "conv":
            h = _conv(h, p, f"unet.{name}", stride=2 if name.endswith(".op") else 1)
            hs.append(h)
        elif kind == "res":
            h = _res(h, p, f"unet.{name}")
            hs.append(h)
        else:                       # attention after the block's res block
            hs[-1] = h = _attn(h, p, f"unet.{name}")
    rest = layout[n_in:]
    for kind, name, _ in rest:
        if name.startswith("middle_block"):
            h = _res(h, p, f"unet.{name}") if kind == "res" else _attn(h, p, f"unet.{name}")
        elif name.startswith("output_blocks"):
            if kind == "res":
                skip = hs.pop()
                h = h[:, :, :skip.shape[2], :skip.shape[3], :skip.shape[4]]
                h = _res(torch.cat([h, skip], 1), p, f"unet.{name}")
            elif kind == "attn":
                h = _attn(h, p, f"unet.{name}")
            else:
                h = _conv(F.interpolate(h, scale_factor=2, mode="nearest"), p, f"unet.{name}")
        elif kind == "norm":
            h = F.leaky_relu(_ln(h, p, f"unet.{name}"), 0.02)
        else:
            h = _conv(h, p, f"unet.{name}")
    return h[0].permute(1, 2, 3, 0)


def unscale(cont: torch.Tensor, ranges: dict) -> torch.Tensor:
    """Network (density, E, nu) in [-1, 1] (clipped) -> physical units:
    10^ of the log10 ranges for density and E, linear for nu."""
    c = cont.to(torch.float64).clamp(-1.0, 1.0)
    lo = torch.tensor([ranges["density_min"], ranges["E_min"], ranges["nu_min"]],
                      dtype=torch.float64, device=c.device)
    hi = torch.tensor([ranges["density_max"], ranges["E_max"], ranges["nu_max"]],
                      dtype=torch.float64, device=c.device)
    v = (c + 1.0) * (hi - lo) / 2.0 + lo
    return torch.cat([10.0 ** v[..., :2], v[..., 2:]], -1)


def material_stage(seg_p: dict, cont_p: dict, feat: torch.Tensor, cfg: dict, tf32: bool):
    """(class logits (D,H,W,K) float32, unscaled (density, E, nu) (D,H,W,3)
    float64) of one grid, with convolutions and products in TF32 or not."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            logits = net_forward(seg_p, feat, cfg, cfg["num_classes"])
            cont = net_forward(cont_p, feat, cfg, cfg["cont_channels"])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return logits, unscale(cont, cfg["normalization_ranges"])
