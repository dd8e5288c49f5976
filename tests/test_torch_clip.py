"""The port's CLIP vision tower and feature extraction
(pixie_tpu_torch/recon/{clip_tower,clip_features}.py) against the JAX
package's (pixie_tpu/recon/{clip_jax,clip_features}.py), on the CPU.

Weights are seeded under HF's ``CLIPVisionModel`` keys (a tower small
enough for the CPU, ``torch_parity.TINY_CLIP``); both packages' converters
read the same state dict.

Tolerances, relative to the largest |value| of the JAX result:
  * tower, float32, square and rectangular patch grids (up and down): 1e-5
    (measured 2.9e-7: float32 sums in another order; LayerNorm with flax's
    fast variance);
  * tower, bfloat16 (the extraction's default): 2e-2 (measured 9.9e-3).
    Both packages round
    the residual stream and each product's output to bfloat16; the port's
    linear layers add their bias in the product's epilogue where flax adds
    it after rounding, and float32 sums of another order round to a
    neighbouring bfloat16 value (a bfloat16 ulp is 2^-8 relative);
  * the position grid's resize against ``jax.image.resize(..., "cubic")``:
    1e-5 (measured 5.2e-7);
  * extraction (PIL resize, normalisation, bfloat16 tower, float16 output)
    against the JAX package's ``extract_clip_features`` from one HF
    snapshot: 2e-2;
  * against HF ``CLIPVisionModel`` in float32 (skipped without
    ``transformers``): 1e-5.  On a rectangular grid HF resizes the position
    grid with plain bicubic (Keys a = -0.75, no antialiasing) where JAX and
    the port follow ``jax.image.resize``: that case runs the port with HF's
    resize in place of its own.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY_CLIP, hf_clip_state_dict, to_np, write_clip_snapshot

from pixie_tpu.recon import clip_jax as JC
from pixie_tpu_torch.recon import clip_features as TCF
from pixie_tpu_torch.recon import clip_tower as TC

F32_RTOL, BF16_RTOL, RESIZE_RTOL = 1e-5, 2e-2, 1e-5
CFG = {k: TINY_CLIP[k] for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                 "num_attention_heads", "patch_size", "image_size")}
# square (the native 4 x 4 grid), up (5 x 7) and down (3 x 2)
GRIDS = [(32, 32), (40, 56), (24, 16)]


def _close(got, want, rtol, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(to_np(got).astype(np.float32), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=err_msg)


@pytest.fixture(scope="module")
def towers():
    sd = hf_clip_state_dict(TINY_CLIP, seed=0)
    jcfg, tcfg = JC.CLIPVisionConfig(**CFG), TC.CLIPVisionConfig(**CFG)
    jparams = JC.convert_clip_vision_state_dict(sd, jcfg)
    tparams = TC.convert_clip_vision_state_dict(sd, tcfg)
    return sd, jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("hw", GRIDS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_matches_jax(towers, hw, dtype):
    _, jcfg, tcfg, jparams, tparams = towers
    px = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    jdt, tdt = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = JC.CLIPVisionTower(jcfg, dtype=jdt).apply({"params": jparams}, px)
    tower = TC.CLIPVisionTower(tcfg, dtype=tdt)
    tower.load_state_dict(tparams)
    with torch.no_grad():
        got = tower(torch.as_tensor(px))
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert tuple(got.shape) == want.shape == (2, 1 + (hw[0] // 8) * (hw[1] // 8), 32)
    _close(got.float(), np.asarray(want, np.float32),
           F32_RTOL if dtype == "float32" else BF16_RTOL)


@pytest.mark.parametrize("shape", [(28, 42), (20, 30), (16, 36), (5, 3)])
def test_position_grid_resize_matches_jax_cubic(shape):
    grid = np.random.default_rng(2).normal(size=(24, 24, 16)).astype(np.float32) * 2.0
    want = jax.image.resize(grid, (*shape, 16), method="cubic")
    _close(TC.resize_position_grid(torch.as_tensor(grid), *shape), want, RESIZE_RTOL)


def test_converters_agree(towers):
    """Both packages' converters on one HF state dict: the same patch
    kernel, embeddings and per-layer weights, in each package's layout."""
    sd, _, _, jp, tp = towers
    assert set(tp) == set(TC.CLIPVisionTower(TC.CLIPVisionConfig(**CFG)).state_dict())
    np.testing.assert_array_equal(to_np(tp["patch_kernel"]), jp["patch_kernel"])
    np.testing.assert_array_equal(to_np(tp["position_embedding"]), jp["position_embedding"])
    np.testing.assert_array_equal(to_np(tp["pre_ln.weight"]), jp["pre_ln"]["scale"])
    for i in range(CFG["num_hidden_layers"]):
        j, t = jp[f"layer_{i}"], f"layers.{i}."
        np.testing.assert_array_equal(to_np(tp[t + "qkv.weight"]),
                                      j["qkv"]["kernel"].reshape(CFG["hidden_size"], -1).T)
        np.testing.assert_array_equal(to_np(tp[t + "qkv.bias"]), j["qkv"]["bias"].reshape(-1))
        for name in ("proj", "fc1", "fc2"):
            np.testing.assert_array_equal(to_np(tp[f"{t}{name}.weight"]), j[name]["kernel"].T)
        np.testing.assert_array_equal(to_np(tp[t + "ln2.bias"]), j["ln2"]["bias"])
    # the prefix is optional, as in JAX
    bare = {k.removeprefix("vision_model."): v for k, v in sd.items()}
    for k, v in TC.convert_clip_vision_state_dict(bare, TC.CLIPVisionConfig(**CFG)).items():
        np.testing.assert_array_equal(to_np(v), to_np(tp[k]), err_msg=k)


def test_read_safetensors(tmp_path):
    """The numpy reader against files the ``safetensors`` package wrote
    (float32, float16, bfloat16, int64; a name filter), and the test
    writer's files."""
    st = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(3)
    tensors = {"a.f32": torch.as_tensor(rng.normal(size=(3, 5)).astype(np.float32)),
               "b.f16": torch.as_tensor(rng.normal(size=(7,)).astype(np.float16)),
               "c.bf16": torch.as_tensor(rng.normal(size=(2, 2, 3))).to(torch.bfloat16),
               "d.i64": torch.arange(6).reshape(2, 3),
               "skip.me": torch.zeros(4)}
    st.save_file(tensors, tmp_path / "m.safetensors", metadata={"format": "pt"})
    got = TCF.read_safetensors(tmp_path / "m.safetensors", keep=lambda n: n != "skip.me")
    assert set(got) == set(tensors) - {"skip.me"}
    for k, v in got.items():
        want = tensors[k].float() if k == "c.bf16" else tensors[k]
        np.testing.assert_array_equal(v, want.numpy(), err_msg=k)
        assert v.dtype == want.numpy().dtype, k
    snap = write_clip_snapshot(tmp_path / "snap", TINY_CLIP, seed=4)
    back = TCF.read_safetensors(snap / "model.safetensors")
    for k, v in hf_clip_state_dict(TINY_CLIP, seed=4).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _pngs(root, n=3, hw=(30, 45)):
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(5)
    paths = []
    for i in range(n):
        img = (rng.uniform(0, 1, (*hw, 3)) * 255).astype(np.uint8)
        paths.append(root / f"v{i}.png")
        Image.fromarray(img).save(paths[-1])
    return paths


def test_snapshot_lookup_and_missing_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.delenv("HF_HOME", raising=False)
    with pytest.raises(RuntimeError, match="CLIP weights unavailable"):
        TCF.load_clip_vision("org/model")
    repo = tmp_path / "hub" / "models--org--model"
    write_clip_snapshot(repo / "snapshots" / "abc", TINY_CLIP, seed=0)
    write_clip_snapshot(repo / "snapshots" / "def", TINY_CLIP, seed=1)
    with pytest.raises(TCF.CLIPWeightsUnavailable):    # two snapshots, no ref
        TCF.load_clip_vision("org/model")
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("def\n")
    assert TCF.find_snapshot("org/model") == repo / "snapshots" / "def"
    cfg, params = TCF.load_clip_vision("org/model")
    assert cfg == TC.CLIPVisionConfig(**CFG)
    want = TC.convert_clip_vision_state_dict(hf_clip_state_dict(TINY_CLIP, seed=1), cfg)
    for k, v in params.items():
        np.testing.assert_array_equal(to_np(v), to_np(want[k]), err_msg=k)
    # a directory given as the model name; a CLIPModel config nests the tower's
    snap = tmp_path / "clipmodel"
    write_clip_snapshot(snap, TINY_CLIP, seed=2)
    (snap / "config.json").write_text(json.dumps({"vision_config": TINY_CLIP,
                                                  "model_type": "clip"}))
    assert TCF.load_clip_vision(str(snap))[0] == cfg


def test_extraction_shape_dtype_and_cache(tmp_path, monkeypatch):
    snap = write_clip_snapshot(tmp_path / "snap", TINY_CLIP, seed=0)
    paths = _pngs(tmp_path / "views")
    cache = tmp_path / "out" / "feats.npy"
    feats = TCF.extract_clip_features(paths, cache_path=cache, model_name=str(snap),
                                      batch_size=2, device="cpu")
    # 30 x 45 -> shortest edge 32 -> 32 x 48: a 4 x 6 patch grid
    assert feats.dtype == np.float16 and feats.shape == (3, 4, 6, 32)
    np.testing.assert_array_equal(np.load(cache), feats)
    # against the tower on the resized views, float32 and bfloat16
    cfg, params = TCF.load_clip_vision(str(snap))
    imgs = TCF.load_views(paths, cfg.image_size, cfg.patch_size)
    assert imgs.shape == (3, 32, 48, 3)
    want = TC.extract_clip_features_torch(imgs, params, cfg, dtype=torch.bfloat16,
                                          batch_size=3, device="cpu")
    np.testing.assert_array_equal(feats, want.astype(np.float16))
    f32 = TCF.extract_clip_features(paths, model_name=str(snap), device="cpu", dtype=None)
    _close(feats, f32, BF16_RTOL)

    def unavailable(*a, **k):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(TCF, "load_clip_vision", unavailable)
    np.testing.assert_array_equal(TCF.extract_clip_features(paths, cache_path=cache), feats)


@pytest.fixture(scope="module")
def hf_model():
    pytest.importorskip("transformers")
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModel

    model = CLIPVisionModel(HFConfig(**TINY_CLIP)).eval()
    sd = {k: torch.as_tensor(v) for k, v in hf_clip_state_dict(TINY_CLIP, seed=6).items()}
    model.load_state_dict(sd, strict=False)
    return model


def _hf_resize(grid, hp, wp):
    """HF CLIP's interpolate_pos_encoding: plain bicubic, no antialiasing."""
    out = torch.nn.functional.interpolate(grid.permute(2, 0, 1)[None], size=(hp, wp),
                                          mode="bicubic", align_corners=False)
    return out[0].permute(1, 2, 0)


@pytest.mark.parametrize("hw", [(32, 32), (40, 56)], ids=["square", "rectangular"])
def test_tower_matches_hf(hf_model, hw, monkeypatch):
    """HF's tower, float32.  On a rectangular grid HF resizes the position
    grid its own way (plain bicubic); with that resize in place of the
    port's (which follows JAX's, held above), the rest agrees as closely."""
    if hw != (32, 32):
        monkeypatch.setattr(TC, "resize_position_grid", _hf_resize)
    cfg = TC.CLIPVisionConfig(**CFG)
    tower = TC.CLIPVisionTower(cfg)
    tower.load_state_dict(TC.convert_clip_vision_state_dict(hf_model.state_dict(), cfg))
    px = np.random.default_rng(7).normal(size=(2, *hw, 3)).astype(np.float32)
    with torch.no_grad():
        want = hf_model(pixel_values=torch.as_tensor(px.transpose(0, 3, 1, 2)),
                        interpolate_pos_encoding=hw != (32, 32)).last_hidden_state
        got = tower(torch.as_tensor(px))
    _close(got, want, F32_RTOL)


def test_extraction_matches_jax_from_one_hf_snapshot(hf_model, tmp_path):
    """Both packages' extract_clip_features from one saved HF snapshot: the
    JAX package loads it through transformers and runs its flax tower in
    bfloat16; the port reads model.safetensors and runs its tower."""
    from pixie_tpu.recon.clip_features import extract_clip_features as jax_extract

    snap = tmp_path / "hf"
    hf_model.save_pretrained(snap)
    paths = _pngs(tmp_path / "views", n=2, hw=(45, 30))
    want = jax_extract(paths, model_name=str(snap), batch_size=2)
    got = TCF.extract_clip_features(paths, model_name=str(snap), batch_size=2, device="cpu")
    assert got.shape == want.shape == (2, 6, 4, 32) and got.dtype == want.dtype
    _close(got, want, BF16_RTOL)
