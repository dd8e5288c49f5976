"""The port's fields (pixie_tpu_torch/recon/{hashgrid,mxu_hash,field,
field_adapter,tcnn_compat,train_field}.py) against the JAX package's.

Inputs and parameters are made with numpy from seeds; JAX parameters reach
the port through ``recon.field.state_dict_from_jax`` (and the tcnn flat
buffers through both packages' ``split_tcnn_params``).

Tolerances, relative to the largest |value| of the JAX result:
  * encodings (both layouts, bf16 on and off, dense and hashed levels,
    points at 0, at 1 and on cell faces): 1e-6.  They agree bit for bit
    here: the hash, the corner weights (x * y * z) and the corner-order
    float32 sums are the same operations, and with ``bf16_dots`` JAX's
    one-hot contraction is bf16(w) * bf16(table) exactly, which the port's
    gather reproduces;
  * tcnn's hash grid + frequency encoding + padded MLP: 1e-5 (float32
    products summed in another order by the two matmuls);
  * fields and adapters: 1e-5 (the same, through two or three layers).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np

from pixie_tpu_torch.recon import field as tfield
from pixie_tpu_torch.recon import field_adapter as tfa
from pixie_tpu_torch.recon import hashgrid as thg
from pixie_tpu_torch.recon import mxu_hash as tmx
from pixie_tpu_torch.recon import tcnn_compat as ttc
from pixie_tpu_torch.recon import train_field as ttf

ENC_RTOL, MLP_RTOL = 1e-6, 1e-5


def _close(got, want, rtol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


def _points(n, res_list, seed=0):
    """(n, 3) points in [0, 1]: random, the corners 0 and 1, and points on the
    cell faces of each resolution."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(0.0, 1.0, (n, 3)), np.zeros((1, 3)), np.ones((1, 3)),
           np.array([[0.0, 1.0, 0.5]])]
    for res in res_list:
        k = rng.integers(0, res + 1, (4, 3))
        face = k / res
        face[:, 1] = rng.uniform(0.0, 1.0, 4)          # on a face, not an edge
        pts.append(face)
    return np.concatenate(pts).astype(np.float32)


def _seeded(tree, seed):
    """The JAX param tree (or its shapes) with every leaf made from a numpy seed: hash
    tables U(0, 1), Dense kernels N(0, 0.3), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "table":
            return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        return (rng.normal(size=a.shape) * (0.3 if name == "kernel" else 0.1)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


# -- encodings --------------------------------------------------------------------

def test_hash_corners_wrap_as_uint32():
    from pixie_tpu.recon.hashgrid import _hash_corners

    rng = np.random.default_rng(3)
    cells = rng.integers(0, 1025, (500, 3)).astype(np.int32)
    for table_size, res in ((2 ** 19, 1024), (4096, 200), (4096, 15)):
        want = np.asarray(_hash_corners(jnp.asarray(cells), table_size, res))
        got = thg.hash_corners(*torch.as_tensor(cells).unbind(-1), table_size, res)
        np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("log2_t", [8, 12])
def test_hashgrid_encoding_matches_jax(log2_t):
    from pixie_tpu.recon.hashgrid import HashGridConfig, HashGridEncoding

    cfg = dict(n_levels=5, features_per_level=2, log2_table_size=log2_t, base_resolution=4,
               max_resolution=64)
    jcfg, tcfg = HashGridConfig(**cfg), thg.HashGridConfig(**cfg)
    assert any((r + 1) ** 3 <= 2 ** log2_t for r in tcfg.resolutions)       # dense levels
    assert any((r + 1) ** 3 > 2 ** log2_t for r in tcfg.resolutions)        # hashed levels
    x = _points(300, tcfg.resolutions)
    table = np.random.default_rng(1).uniform(0, 1, (5, 2 ** log2_t, 2)).astype(np.float32)
    want = HashGridEncoding(jcfg).apply({"params": {"table": jnp.asarray(table)}}, x)
    enc = thg.HashGridEncoding(tcfg)
    enc.load_state_dict({"table": torch.as_tensor(table)})
    with torch.no_grad():
        got = enc(torch.as_tensor(x))
    _close(got, want, ENC_RTOL)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))      # bit for bit


@pytest.mark.parametrize("bf16", [True, False])
def test_mxu_encoding_matches_jax(bf16):
    from pixie_tpu.recon.mxu_hash import MXUHashConfig, MXUHashEncoding

    cfg = dict(n_levels=5, features_per_level=2, lo=32, hi=8, base_resolution=4,
               max_resolution=64, bf16_dots=bf16)
    jcfg, tcfg = MXUHashConfig(**cfg), tmx.MXUHashConfig(**cfg)
    x = _points(297, tcfg.resolutions, seed=2).reshape(80, 4, 3)   # a batch shape
    table = np.random.default_rng(2).uniform(0, 1, (5, 32, 8, 2)).astype(np.float32)
    want = MXUHashEncoding(jcfg).apply({"params": {"table": jnp.asarray(table)}}, x)
    enc = tmx.MXUHashEncoding(tcfg)
    enc.load_state_dict({"table": torch.as_tensor(table)})
    with torch.no_grad():
        got = enc(torch.as_tensor(x))
    assert got.shape == (80, 4, 10)
    _close(got, want, ENC_RTOL)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))      # bit for bit


def test_frequency_and_sh_encodings_match_jax():
    from pixie_tpu.recon.hashgrid import frequency_encoding, sh_encoding

    x = _points(200, [8])
    d = np.random.default_rng(4).normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(thg.frequency_encoding(torch.as_tensor(x), 6), frequency_encoding(x, 6), ENC_RTOL)
    for degree in (1, 2, 3, 4):
        _close(thg.sh_encoding(torch.as_tensor(d), degree), sh_encoding(d, degree), ENC_RTOL)


# -- fields -----------------------------------------------------------------------

def _nerf_pair(seed=10):
    from pixie_tpu.recon.field import NerfField

    jf = NerfField()
    params = _seeded(jax.eval_shape(jf.init, jax.random.PRNGKey(0), jnp.zeros((2, 3))), seed)
    tf = tfield.NerfField()
    tf.load_state_dict(tfield.state_dict_from_jax(params))
    return jf, params, tf


def _feat_pair(dim, seed=11):
    from pixie_tpu.recon.field import FeatureField

    jf = FeatureField(feature_dim=dim)
    params = _seeded(jax.eval_shape(jf.init, jax.random.PRNGKey(0), jnp.zeros((2, 3))), seed)
    sd = tfield.state_dict_from_jax(params)
    tf = tfield.feature_field_for(sd)
    tf.load_state_dict(sd)
    return jf, params, tf


@pytest.fixture(scope="module")
def fields():
    """The MXU NerfField and a 32-wide FeatureField (seeded), and JAX's
    FieldAdapter over them: its jitted queries are the JAX fields as the
    voxelizer runs them, compiled once for N_PTS points."""
    from pixie_tpu.recon.field_adapter import FieldAdapter

    nerf, feat = _nerf_pair(), _feat_pair(32)
    return nerf, feat, FieldAdapter(nerf[1], feat[1], feature_dim=32)


N_PTS = 400


def test_nerf_field_density_and_rgb(fields):
    """NerfField density only and with rgb (view direction 0, as the
    adapter asks for it) on points at 0, 1 and on cell faces."""
    (jf, params, tf), (_, fparams, _), ja = fields
    x = _points(N_PTS - 3 - 12, [16, 64, 512])
    with torch.no_grad():
        dens = tf(torch.as_tensor(x), None, True)
        dens2, rgb = tf(torch.as_tensor(x))
    jdens, _ = ja._query_fn(params, fparams, x)
    _close(dens, jdens, MLP_RTOL)
    _close(dens2, jdens, MLP_RTOL)
    _close(rgb, ja._rgb_fn(params, x), MLP_RTOL)
    assert float(np.asarray(jdens).std()) > 0 and float(to_np(rgb).std()) > 0


def test_nerf_field_hashgrid_layout():
    """encoding="hashgrid": the tcnn-layout table of field.py:64-69 (the
    encoding's arithmetic is held against JAX's above)."""
    from pixie_tpu.recon.hashgrid import HashGridConfig

    tf = tfield.NerfField(encoding="hashgrid")
    assert tf.grid.config.__dict__ == HashGridConfig(
        n_levels=16, features_per_level=2, log2_table_size=19, base_resolution=16,
        max_resolution=1024).__dict__
    assert tf.grid.table.shape == (16, 2 ** 19, 2)
    with pytest.raises(ValueError, match="encoding"):
        tfield.NerfField(encoding="dense")


@pytest.mark.parametrize("dim", [32, 768])
def test_feature_field(dim, fields):
    _, (jf, params, tf), ja = fields
    if dim == 768:
        jf, params, tf = _feat_pair(dim)
    assert tf.grid.table.shape == (12, *tfield.FEAT_LOHI, 8)
    x = _points(N_PTS - 3 - 8, [16, 128], seed=6)
    with torch.no_grad():
        got = tf(torch.as_tensor(x))
    want = (ja._query_fn(fields[0][1], params, x)[1] if dim == 32
            else jax.jit(jf.apply)(params, x))
    assert got.shape == (x.shape[0], dim)
    _close(got, want, MLP_RTOL)


def test_state_dict_from_jax_layout(fields):
    _, params, tf = fields[0]
    sd = tfield.state_dict_from_jax(params)
    assert set(sd) == set(tf.state_dict())
    k = np.asarray(params["params"]["density_mlp"]["dense_0"]["kernel"])
    np.testing.assert_array_equal(to_np(sd["density_mlp.dense_0.weight"]), k.T)
    np.testing.assert_array_equal(to_np(sd["grid.table"]),
                                  np.asarray(params["params"]["grid"]["table"]))


DATAPARSER = {"scale": 0.8, "transform": [[0.0, -1.0, 0.0, 0.05], [1.0, 0.0, 0.0, -0.1],
                                          [0.0, 0.0, 1.0, 0.02]]}


def test_field_adapter_query_and_rgb(fields):
    """FieldAdapter.query / get_rgb / get_alpha against JAX's, without and
    with a dataparser transform (JAX's adapter with its host-side map
    switched, so that its jitted queries compile once).  alpha = 1 -
    exp(-d delta) cancels against 1: it is held to one float32 ulp of 1.0
    (1.2e-7) on top of MLP_RTOL.  Without a feature field the feature is
    [density, 0]."""
    (_, nparams, _), (_, fparams, _), ja = fields
    pts = np.random.default_rng(7).uniform(-0.5, 0.5, (N_PTS, 3)).astype(np.float32)
    nsd, fsd = tfield.state_dict_from_jax(nparams), tfield.state_dict_from_jax(fparams)
    for transform in (False, True):
        kw = dict(world_to_nerf_scale=DATAPARSER["scale"],
                  world_to_nerf_transform=np.asarray(DATAPARSER["transform"])) \
            if transform else {}
        ja.scale = kw.get("world_to_nerf_scale", 1.0)
        ja.transform = (np.asarray(DATAPARSER["transform"], np.float32) if transform
                        else None)
        ta = tfa.FieldAdapter(nsd, fsd, feature_dim=32, device="cpu", **kw)
        jq, tq = ja.query(pts), ta.query(pts)
        _close(tq["density"], jq["density"], MLP_RTOL, f"transform {transform}")
        _close(tq["feature"], jq["feature"], MLP_RTOL, f"transform {transform}")
        _close(ta.get_rgb(pts), ja.get_rgb(pts), MLP_RTOL, f"transform {transform}")
        delta = np.float32(1 / 64)
        want = np.asarray(ja.get_alpha(pts, delta))
        np.testing.assert_allclose(to_np(ta.get_alpha(pts, delta)), want, rtol=0,
                                   atol=2.0 ** -23 + MLP_RTOL * np.abs(want).max())
        tn = tfa.FieldAdapter(nsd, None, device="cpu", **kw).query(pts)["feature"]
        assert tn.shape == (N_PTS, 2) and not tn[:, 1].any()
        _close(tn[:, :1], jq["density"], MLP_RTOL)
    with pytest.raises(ValueError, match="wide"):
        tfa.FieldAdapter(nsd, fsd, feature_dim=768, device="cpu")


def test_field_checkpoint_round_trip(tmp_path, fields):
    (_, _, tn), (_, _, tfeat), _ = fields
    path = ttf.save_field_checkpoint(tmp_path, {"nerf": tn, "feat": tfeat}, feature_dim=32)
    assert path == tmp_path / "checkpoints" / "field.pth"
    meta = json.loads((tmp_path / "checkpoints" / "field_meta.json").read_text())
    assert meta == {"feature_dim": 32, "with_features": True, "encoding": "mxu"}
    loaded = ttf.load_field_checkpoint(tmp_path)
    for name, mod in (("nerf", tn), ("feat", tfeat)):
        assert set(loaded[name]) == set(mod.state_dict())
        for k, v in mod.state_dict().items():
            assert torch.equal(loaded[name][k], v)
    (tmp_path / "dataparser_transforms.json").write_text(json.dumps(DATAPARSER))
    adapter = tfa.load_field_adapter(tmp_path, device="cpu")
    assert adapter.scale == 0.8 and adapter.transform.shape == (3, 4)
    direct = tfa.FieldAdapter(tn.state_dict(), tfeat.state_dict(), feature_dim=32,
                              world_to_nerf_scale=0.8,
                              world_to_nerf_transform=np.asarray(DATAPARSER["transform"]),
                              device="cpu")
    pts = np.random.default_rng(8).uniform(-0.5, 0.5, (100, 3)).astype(np.float32)
    for key in ("density", "feature"):
        assert torch.equal(adapter.query(pts)[key], direct.query(pts)[key])


def test_orbax_only_checkpoint_raises(tmp_path):
    (tmp_path / "checkpoints" / "field").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="orbax"):
        ttf.load_field_checkpoint(tmp_path)
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "checkpoints" / "field")):
        tfa.load_field_adapter(tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="no field checkpoint"):
        ttf.load_field_checkpoint(tmp_path / "elsewhere")


def test_entry_points_default_to_cuda():
    import inspect

    from pixie_tpu_torch import pipeline

    for fn in (tfa.load_field_adapter, tfa.FieldAdapter.__init__,
               ttc.TcnnFieldAdapter.__init__, pipeline.generate_voxels):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# -- tcnn -------------------------------------------------------------------------

def test_tcnn_network_matches_jax_on_one_flat_buffer():
    from pixie_tpu.recon import tcnn_compat as jtc

    grid = dict(n_levels=4, features_per_level=2, log2_hashmap_size=9, base_resolution=4,
                max_resolution=64)
    jgrid, tgrid = (m.TcnnGridConfig.from_min_max(*grid.values()) for m in (jtc, ttc))
    assert any(tgrid.level_is_hashed(l) for l in range(4))
    assert not all(tgrid.level_is_hashed(l) for l in range(4))
    mlp = dict(in_dim=8 + 3 * 2 * 2, out_dim=5, hidden=16, n_hidden_layers=2)
    jmlp, tmlp = jtc.TcnnMLPConfig(**mlp), ttc.TcnnMLPConfig(**mlp)
    rng = np.random.default_rng(9)
    flat = np.concatenate([rng.normal(0, 0.3, tmlp.n_params),
                           rng.uniform(-1e-2, 1e-2, tgrid.n_params)]).astype(np.float32)
    x = _points(300, [4, 16, 64], seed=9)
    jnet = jtc.TcnnNetworkWithInputEncoding(jgrid, jmlp, pe_n_freq=2)
    want = jnet.apply({"params": jtc.split_tcnn_params(flat, jgrid, jmlp)}, x)
    tnet = ttc.TcnnNetworkWithInputEncoding(tgrid, tmlp, pe_n_freq=2)
    tnet.load_state_dict(ttc.split_tcnn_params(flat, tgrid, tmlp))
    with torch.no_grad():
        got = tnet(torch.as_tensor(x))
    assert got.shape == (x.shape[0], 5)
    _close(got, want, MLP_RTOL)
    assert ttc.detect_layout(flat, tmlp.n_params, tgrid.n_params)
    with pytest.raises(ValueError, match="expected"):
        ttc.split_tcnn_params(flat[:-1], tgrid, tmlp)


def write_f3rm_ckpt(path, seed=0, network_first=True):
    """A seeded nerfstudio/f3rm ``step-*.ckpt``: the F3RM feature field, a
    nerfacto mlp_base at max_res 2048, the colour head and an appearance
    embedding, under the keys find_tcnn_buffers reads."""
    rng = np.random.default_rng(seed)

    def buffer(n_net, n_enc):
        net = rng.normal(0.0, 0.3, n_net).astype(np.float32)
        enc = rng.uniform(-0.5, 0.5, n_enc).astype(np.float32)
        return torch.as_tensor(np.concatenate([net, enc] if network_first else [enc, net]))

    base = ttc.nerfacto_density_field(max_res=2048)
    state = {
        "_model.feature_field.field.params": buffer(ttc.F3RM_MLP.n_params,
                                                    ttc.F3RM_GRID.n_params),
        "_model.field.mlp_base.params": buffer(base.mlp.config.n_params,
                                               base.grid.config.n_params),
        "_model.field.mlp_head.params": torch.as_tensor(
            rng.normal(0.0, 0.3, ttc.NERFACTO_HEAD_MLP.n_params).astype(np.float32)),
        "_model.field.embedding_appearance.embedding.weight": torch.as_tensor(
            rng.normal(0.0, 0.5, (12, 32)).astype(np.float32)),
        "_model.field.step": torch.tensor(7),
    }
    torch.save({"pipeline": state, "step": 0}, path)
    return path


def test_load_f3rm_checkpoint_matches_jax(tmp_path):
    from pixie_tpu.recon import tcnn_compat as jtc

    ckpt = write_f3rm_ckpt(tmp_path / "step-0.ckpt")
    jfields = jtc.load_f3rm_checkpoint(ckpt)
    tfields = ttc.load_f3rm_checkpoint(ckpt)
    assert set(tfields) == set(jfields) == {"feature_field", "mlp_base", "mlp_head",
                                            "appearance"}
    kw = dict(world_to_nerf_scale=DATAPARSER["scale"],
              world_to_nerf_transform=np.asarray(DATAPARSER["transform"]))
    ja = jtc.TcnnFieldAdapter(jfields, **kw)
    ta = ttc.TcnnFieldAdapter(tfields, device="cpu", **kw)
    pts = np.random.default_rng(12).uniform(-0.5, 0.5, (256, 3)).astype(np.float32)
    jq, tq = ja.query(pts), ta.query(pts)
    assert tq["feature"].shape == (256, 768)
    _close(tq["feature"], jq["feature"], MLP_RTOL)
    _close(tq["density"], jq["density"], MLP_RTOL)
    _close(ta.get_rgb(pts), ja.get_rgb(pts), MLP_RTOL)
    feats, ar = ta.query_packed_chunks(pts, 100, np.float32(1 / 64))
    assert feats.shape == (256, 768) and ar.shape == (256, 4) and feats.dtype == torch.float16
