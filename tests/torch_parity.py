"""Shared helpers of the pixie_tpu_torch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX function
and its PyTorch port (CPU, plain versions of the kernels); results come back
as numpy arrays.  JAX is imported only by the helpers that need it, so the
card-only tests (tests/test_torch_cuda.py) import no JAX package module.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# tier-1 runs 6 xdist workers: keep each worker's intra-op pool small
torch.set_num_threads(2)


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def random_particles(n=300, seed=0):
    """The random state of tests/test_fast_solver.py:23-38 as numpy arrays."""
    rng = np.random.default_rng(seed)  # draw order as there: x, v, C, stress
    d = {"x": rng.uniform(0.4, 1.6, (n, 3)).astype(np.float32),
         "vol": np.full(n, 1e-5, np.float32),
         "v": rng.normal(size=(n, 3)).astype(np.float32),
         "C": (0.1 * rng.normal(size=(n, 3, 3))).astype(np.float32)}
    s = 1e3 * rng.normal(size=(n, 3, 3))
    d["stress"] = (0.5 * (s + np.swapaxes(s, -1, -2))).astype(np.float32)
    return d


def make_pair(d: dict, density=300.0, E=1e5, nu=0.35, material=0, **state_kw):
    """(jax MPMState, torch MPMState) built from the same numpy arrays.
    Extra keyword arrays (e.g. F_trial, selection) overwrite state fields."""
    import jax.numpy as jnp

    from pixie_tpu.sim import types as jt
    from pixie_tpu_torch.sim import types as tt

    common = dict(density=density, E=E, nu=nu, material=material)
    js = jt.finalize_mu_lam(jt.make_state(d["x"], d["vol"], **common))
    ts = tt.finalize_mu_lam(tt.make_state(d["x"], d["vol"], **common))
    extra = {k: d[k] for k in ("v", "C", "stress") if k in d}
    extra.update(state_kw)
    if extra:
        js = js.replace(**{k: jnp.asarray(v) for k, v in extra.items()})
        ts = ts.replace(**{k: torch.as_tensor(np.array(v)) for k, v in extra.items()})
    return js, ts


def configs(**kw):
    """(jax MPMConfig, torch MPMConfig) with the same fields."""
    from pixie_tpu.sim.types import MPMConfig as JC
    from pixie_tpu_torch.sim.types import MPMConfig as TC

    return JC(**kw), TC(**kw)


def assert_state_close(js, ts, tol: dict):
    """tol: field -> (atol, rtol)."""
    for field, (atol, rtol) in tol.items():
        np.testing.assert_allclose(to_np(getattr(ts, field)), np.asarray(getattr(js, field)),
                                   atol=atol, rtol=rtol, err_msg=field)


def splat_scene(n, seed=0, scale=0.03):
    """Random gaussians (numpy) with SH degree 3 and anisotropic scales, and
    a view matrix at z = -2 (tests/test_gaussians.py's tiled scene)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    p = {
        "xyz": rng.uniform(-0.6, 0.6, (n, 3)),
        "f_dc": rng.normal(0.0, 0.5, (n, 1, 3)),
        "f_rest": rng.normal(0.0, 0.2, (n, 15, 3)),
        "scaling": np.log(scale) + rng.normal(0.0, 0.2, (n, 3)),
        "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
        "opacity": rng.uniform(-1.0, 2.0, (n, 1)),
    }
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 2.0
    return {k: v.astype(np.float32) for k, v in p.items()}, vm


def underflow_scene():
    """60 random gaussians plus 40 opaque ones stacked along the view axis
    over one tile at 64x64: there T falls below float32's range (0 from the
    ~23rd splat on).  Returns (params, viewmat) as numpy."""
    p, vm = splat_scene(60, seed=5)
    rng = np.random.default_rng(6)
    k = 40
    stack = {
        "xyz": np.column_stack([0.05 + 0.01 * rng.normal(size=k),
                                0.05 + 0.01 * rng.normal(size=k), np.linspace(-0.3, 0.3, k)]),
        "f_dc": rng.normal(0.0, 0.5, (k, 1, 3)),
        "f_rest": rng.normal(0.0, 0.2, (k, 15, 3)),
        "scaling": np.full((k, 3), np.log(0.04)) + rng.normal(0.0, 0.1, (k, 3)),
        "rotation": np.tile([1.0, 0.0, 0.0, 0.0], (k, 1)),
        "opacity": np.full((k, 1), 6.0),      # sigmoid 0.9975: clamped to 0.99 at the centre
    }
    return {kk: np.concatenate([p[kk], stack[kk].astype(np.float32)]) for kk in p}, vm


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip: these tests run the hand-written kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# a CLIP vision tower small enough for the CPU, as HF config.json keys
TINY_CLIP = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, patch_size=8, image_size=32, layer_norm_eps=1e-5,
                 hidden_act="quick_gelu", num_channels=3)


def hf_clip_state_dict(cfg: dict, seed: int = 0) -> dict:
    """Seeded HF ``CLIPVisionModel`` weights (numpy, ``vision_model.*``
    keys): linear weights N(0, 1/fan_in), biases N(0, 0.02), LayerNorm
    scales 1 + N(0, 0.1) and offsets N(0, 0.1), embeddings N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    hid, inter, p = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    n_pos = 1 + (cfg["image_size"] // p) ** 2

    def normal(shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    sd = {"vision_model.embeddings.class_embedding": normal((hid,), 0.5),
          "vision_model.embeddings.patch_embedding.weight": normal((hid, 3, p, p),
                                                                   (3 * p * p) ** -0.5),
          "vision_model.embeddings.position_embedding.weight": normal((n_pos, hid), 0.5)}

    def norm(name):
        sd[f"{name}.weight"] = 1.0 + normal((hid,), 0.1)
        sd[f"{name}.bias"] = normal((hid,), 0.1)

    def linear(name, n_out, n_in):
        sd[f"{name}.weight"] = normal((n_out, n_in), n_in ** -0.5)
        sd[f"{name}.bias"] = normal((n_out,), 0.02)

    norm("vision_model.pre_layrnorm")
    for i in range(cfg["num_hidden_layers"]):
        lp = f"vision_model.encoder.layers.{i}."
        for n in ("q", "k", "v", "out"):
            linear(f"{lp}self_attn.{n}_proj", hid, hid)
        norm(lp + "layer_norm1")
        norm(lp + "layer_norm2")
        linear(lp + "mlp.fc1", inter, hid)
        linear(lp + "mlp.fc2", hid, inter)
    norm("vision_model.post_layernorm")
    return sd


def write_safetensors(path, arrays: dict) -> None:
    """A ``.safetensors`` file of float32 numpy arrays (the format's header:
    an 8-byte little-endian length, then JSON with each tensor's dtype,
    shape and byte range)."""
    import json

    header, offset = {}, 0
    for name, a in arrays.items():
        n = np.asarray(a, "<f4").nbytes
        header[name] = {"dtype": "F32", "shape": list(np.shape(a)),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for a in arrays.values():
            f.write(np.ascontiguousarray(a, "<f4").tobytes())


def write_clip_snapshot(path, cfg: dict, seed: int = 0):
    """A local HF snapshot directory of a seeded CLIPVisionModel:
    config.json and model.safetensors."""
    import json
    from pathlib import Path

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(dict(cfg, model_type="clip_vision_model",
                                                      architectures=["CLIPVisionModel"])))
    write_safetensors(path / "model.safetensors", hf_clip_state_dict(cfg, seed))
    return path


# a CLIP text tower small enough for the CPU, as HF text_config keys
TINY_TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=77, layer_norm_eps=1e-5,
                 hidden_act="quick_gelu")


def hf_clip_text_state_dict(cfg: dict, vocab_size: int, projection_dim: int,
                            seed: int = 0) -> dict:
    """Seeded HF ``CLIPModel`` text weights (numpy, ``text_model.*`` and
    ``text_projection.weight``), at the scales of ``hf_clip_state_dict``."""
    rng = np.random.default_rng(seed)
    hid, inter = cfg["hidden_size"], cfg["intermediate_size"]

    def normal(shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    sd = {"text_model.embeddings.token_embedding.weight": normal((vocab_size, hid), 0.5),
          "text_model.embeddings.position_embedding.weight":
              normal((cfg["max_position_embeddings"], hid), 0.5)}

    def norm(name):
        sd[f"{name}.weight"] = 1.0 + normal((hid,), 0.1)
        sd[f"{name}.bias"] = normal((hid,), 0.1)

    def linear(name, n_out, n_in):
        sd[f"{name}.weight"] = normal((n_out, n_in), n_in ** -0.5)
        sd[f"{name}.bias"] = normal((n_out,), 0.02)

    for i in range(cfg["num_hidden_layers"]):
        lp = f"text_model.encoder.layers.{i}."
        for n in ("q", "k", "v", "out"):
            linear(f"{lp}self_attn.{n}_proj", hid, hid)
        norm(lp + "layer_norm1")
        norm(lp + "layer_norm2")
        linear(lp + "mlp.fc1", inter, hid)
        linear(lp + "mlp.fc2", hid, inter)
    norm("text_model.final_layer_norm")
    sd["text_projection.weight"] = normal((projection_dim, hid), hid ** -0.5)
    return sd


def write_clip_model_snapshot(path, corpus, text_cfg: dict = TINY_TEXT, vision_cfg: dict = TINY_CLIP,
                              projection_dim: int = 16, n_merges: int = 200,
                              legacy_eos: bool = True, seed: int = 0):
    """A local HF snapshot directory of a seeded ``CLIPModel``: config.json
    (``text_config``, ``vision_config``, ``projection_dim``),
    model.safetensors with the text and vision keys, and a seeded
    vocab.json / merges.txt of the real layout (``chip_smoke._bpe_vocab``:
    merges learned on ``corpus`` first, then seeded ones at seeded ranks).
    ``legacy_eos``: the text config's ``eos_token_id`` is 2, as OpenAI's
    checkpoints carry it (argmax pooling); else ``<|endoftext|>``'s id."""
    import json
    from pathlib import Path

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    from chip_smoke import _bpe_vocab

    vocab, merges, _ = _bpe_vocab(corpus, n_merges, seed)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    eos = vocab["<|endoftext|>"]
    text = dict(text_cfg, vocab_size=len(vocab), model_type="clip_text_model",
                bos_token_id=vocab["<|startoftext|>"], pad_token_id=1,
                eos_token_id=2 if legacy_eos else eos)
    (path / "config.json").write_text(json.dumps({
        "architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": projection_dim,
        "text_config": text,
        "vision_config": dict(vision_cfg, model_type="clip_vision_model")}))
    sd = hf_clip_state_dict(vision_cfg, seed)
    sd.update(hf_clip_text_state_dict(text, len(vocab), projection_dim, seed + 1))
    sd["visual_projection.weight"] = np.zeros((projection_dim, vision_cfg["hidden_size"]),
                                              np.float32)
    sd["logit_scale"] = np.asarray(2.6592, np.float32)
    write_safetensors(path / "model.safetensors", sd)
    return path
