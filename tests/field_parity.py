"""Shared pieces of the field-training parity tests
(tests/test_torch_field_render.py, tests/test_torch_field_train.py): small
nerf and feature fields in both packages, seeded JAX parameters, rays, and
the two packages' renders.

The small fields are the shipped classes with their encodings cut to 2-3
levels (``SmallNerf`` / ``SmallFeat``; flax modules of the same layers,
``JSmallNerf`` / ``JSmallFeat``, beside them): XLA's compile of one gradient
through the shipped NerfField + FeatureField + ProposalField takes ~3
minutes on a CPU (each field alone 4-14 s; the blow-up comes with the
sample positions' gradient).  The proposal field is always the shipped one.
"""

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as fnn

from torch_parity import to_np

from pixie_tpu.recon import field as JF
from pixie_tpu.recon.hashgrid import HashGridConfig as JHGC
from pixie_tpu.recon.hashgrid import HashGridEncoding as JHGE
from pixie_tpu.recon.hashgrid import frequency_encoding as j_freq
from pixie_tpu.recon.hashgrid import sh_encoding as j_sh
from pixie_tpu.recon.mxu_hash import MXUHashConfig as JMXC
from pixie_tpu.recon.mxu_hash import MXUHashEncoding as JMXE
from pixie_tpu_torch.recon import field as TF
from pixie_tpu_torch.recon.hashgrid import HashGridConfig as THGC
from pixie_tpu_torch.recon.mxu_hash import MXUHashConfig as TMXC

N_RAYS, RCFG = 64, dict(n_coarse=16, n_fine=8)
FEAT_DIM = 16

NERF_MXU = dict(n_levels=3, features_per_level=2, lo=32, hi=16, base_resolution=4,
                max_resolution=32)
NERF_HG = dict(n_levels=3, features_per_level=2, log2_table_size=10, base_resolution=4,
               max_resolution=32)
FEAT_MXU = dict(n_levels=2, features_per_level=4, lo=32, hi=16, base_resolution=4,
                max_resolution=16)
FEAT_HG = dict(n_levels=2, features_per_level=4, log2_table_size=10, base_resolution=4,
               max_resolution=16)


class SmallNerf(TF.NerfField):
    MXU, HASHGRID = TMXC(**NERF_MXU), THGC(**NERF_HG)


class SmallFeat(TF.FeatureField):
    MXU, HASHGRID = TMXC(**FEAT_MXU), THGC(**FEAT_HG)


def _j_grid(kind, mxu, hg):
    return JMXE(JMXC(**mxu), name="grid") if kind == "mxu" else JHGE(JHGC(**hg), name="grid")


class JSmallNerf(fnn.Module):
    """pixie_tpu's NerfField with SmallNerf's encodings."""

    geo_dim: int = 15
    encoding: str = "mxu"

    @fnn.compact
    def __call__(self, positions, directions=None, density_only: bool = False):
        enc = _j_grid(self.encoding, NERF_MXU, NERF_HG)(positions)
        h = JF.MLP(64, 1, 1 + self.geo_dim, name="density_mlp")(enc)
        density = jnp.exp(jnp.clip(h[..., :1] - 1.0, -15.0, 15.0))
        if density_only:
            return density
        if directions is None:
            directions = jnp.zeros_like(positions)
        rgb = JF.MLP(64, 2, 3, name="color_mlp")(
            jnp.concatenate([h[..., 1:], j_sh(directions, degree=4)], axis=-1))
        return density, jax.nn.sigmoid(rgb)


class JSmallFeat(fnn.Module):
    """pixie_tpu's FeatureField with SmallFeat's encodings."""

    feature_dim: int = FEAT_DIM
    use_pe: bool = True
    pe_n_freq: int = 6
    encoding: str = "mxu"

    @fnn.compact
    def __call__(self, positions):
        enc = _j_grid(self.encoding, FEAT_MXU, FEAT_HG)(positions)
        if self.use_pe:
            enc = jnp.concatenate([enc, j_freq(positions, self.pe_n_freq)], axis=-1)
        return JF.MLP(64, 2, self.feature_dim, name="mlp")(enc)


def _seeded(tree, seed):
    """The JAX param tree (or its shapes) with every leaf made from a numpy
    seed: hash tables U(0, 1), Dense kernels N(0, 0.3), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "table":
            return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        return (rng.normal(size=a.shape) * (0.3 if name == "kernel" else 0.1)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_fields(encoding, small=True, feature_dim=FEAT_DIM):
    nerf = JSmallNerf(encoding=encoding) if small else JF.NerfField(encoding=encoding)
    feat = (JSmallFeat(encoding=encoding, feature_dim=feature_dim) if small
            else JF.FeatureField(encoding=encoding, feature_dim=feature_dim))
    return {"nerf": nerf, "feat": feat, "prop": JF.ProposalField()}


def _port_fields(encoding, params, small=True, feature_dim=FEAT_DIM):
    fields = {"nerf": (SmallNerf if small else TF.NerfField)(encoding=encoding),
              "feat": (SmallFeat if small else TF.FeatureField)(encoding=encoding,
                                                                feature_dim=feature_dim),
              "prop": TF.ProposalField()}
    for k, m in fields.items():
        m.load_state_dict(TF.state_dict_from_jax(params[k]))
    return fields


def _seeded_params(jfields, seed=0):
    d = jnp.zeros((2, 3))
    shapes = {"nerf": jax.eval_shape(lambda k: jfields["nerf"].init(k, d, d, False),
                                     jax.random.PRNGKey(0)),
              "feat": jax.eval_shape(lambda k: jfields["feat"].init(k, d), jax.random.PRNGKey(0)),
              "prop": jax.eval_shape(lambda k: jfields["prop"].init(k, d), jax.random.PRNGKey(0))}
    return {k: _seeded(v, seed + i) for i, (k, v) in enumerate(shapes.items())}


def _rays(n=N_RAYS, seed=5):
    """Rays from ~1.5-2.5 out, aimed near the origin (inside near/far)."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(-0.3, 0.3, (n, 3))
    origins = rng.normal(size=(n, 3))
    origins *= rng.uniform(1.5, 2.5, (n, 1)) / np.linalg.norm(origins, axis=1, keepdims=True)
    dirs = target - origins
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins.astype(np.float32), dirs.astype(np.float32)


def _jax_render(kind, jf, rcfg, train, with_features=True):
    def fn(params, o, d, key):
        nerf_apply = lambda p, x, dd, do: jf["nerf"].apply(p, x, dd, do)  # noqa: E731
        feat_apply = (lambda p, x: jf["feat"].apply(p, x)) if with_features else None  # noqa: E731
        if kind == "prop":
            return JF.render_rays_prop(lambda p, x: jf["prop"].apply(p, x), nerf_apply,
                                       feat_apply, params["prop"], params["nerf"],
                                       params.get("feat"), o, d, key, rcfg, train=train,
                                       with_features=with_features)
        return JF.render_rays(nerf_apply, feat_apply, params["nerf"], params.get("feat"), o, d,
                              key, rcfg, train=train, with_features=with_features)
    return fn


def _port_render(kind, fields, o, d, rcfg, train, draws, with_features=True):
    feat = fields["feat"] if with_features else None
    if kind == "prop":
        return TF.render_rays_prop(fields["prop"], fields["nerf"], feat, o, d, rcfg,
                                   train=train, with_features=with_features, draws=draws)
    return TF.render_rays(fields["nerf"], feat, o, d, rcfg, train=train,
                          with_features=with_features, draws=draws)


def _jax_draws(key, n, rcfg):
    """The uniforms JAX's train-mode renders draw from ``key``."""
    return (np.asarray(jax.random.uniform(key, (n, rcfg.n_coarse))),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (n, rcfg.n_fine))))


def _cotangents(out, seed=9):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=np.shape(out[k])).astype(np.float32)
            for k in ("rgb", "depth", "accumulation", "feature")}


def _close(got, want, rtol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)
