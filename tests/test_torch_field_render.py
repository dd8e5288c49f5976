"""Field training's renders, port vs JAX package, on the CPU: the proposal
field, ``render_rays`` and ``render_rays_prop`` (eval mode, train mode on
JAX's own draws, the gradient of every parameter tensor against
``jax.grad``) on both encodings, and the searchsorted / gather forms of
JAX's compare-counts.

Fields: the shipped ProposalField and the small nerf and feature fields of
tests/field_parity.py; the shipped widths are held in eval mode once, and
their encodings and MLPs in tests/test_torch_field.py.  The draws are JAX's
own (``jax.random.uniform`` of the keys JAX's renders use).

Tolerances, relative to the largest |value| of the JAX result (gradients:
of each parameter tensor's JAX gradient); "measured" is the largest seen:
  * ProposalField: 1e-5 (float32 MLP sums in another order);
  * render_rays on hashgrid, outputs and gradients: 1e-5 (measured 2.2e-6);
  * the rest, outputs 1e-3 (measured 5.3e-4), float32 gradients on hashgrid
    1e-3 (measured 4.7e-4), MXU gradients 2e-2 (measured 8.2e-3).  Sample
    positions agree to a few float32 ulps, not bit for bit: torch's CPU
    cumsum accumulates in double where XLA adds in float32, and XLA
    contracts multiply-adds (the stratified and inverse-CDF samples); the
    seeded fields' slopes amplify that, and the MXU encoding's bfloat16
    trilinear weights round a shifted position to another bfloat16 value.
    The MXU tables' gradients are rounded to bfloat16 where a cast sits: JAX
    per corner and level (each one-hot dot's output), the port once on a
    table's summed gradient (measured 3.2e-3 of the largest; the proposal
    field is MXU on both encodings);
The rgb loss reaches the proposal field through the fine sample positions,
as in JAX (``PIXIE_DETACH_SAMPLES=0``, its default; nerfacto detaches
them): ``test_rgb_loss_reaches_the_proposal_field`` holds that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from field_parity import (
    JF, N_RAYS, RCFG, TF, _close, _cotangents, _jax_draws, _jax_fields, _jax_render,
    _port_fields, _port_render, _rays, _seeded, _seeded_params,
)
from torch_parity import to_np

TIGHT_RTOL, OUT_RTOL, GRAD_RTOL, GRAD_MXU_RTOL = 1e-5, 1e-3, 1e-3, 2e-2


# -- the proposal field --------------------------------------------------------------

def test_proposal_field_matches_jax():
    jp = JF.ProposalField()
    params = _seeded(jax.eval_shape(jp.init, jax.random.PRNGKey(0), jnp.zeros((2, 3))), 3)
    x = np.random.default_rng(4).uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    want = jp.apply(params, x)
    tp = TF.ProposalField()
    tp.load_state_dict(TF.state_dict_from_jax(params))
    assert set(tp.state_dict()) == {"grid.table", "density_mlp.dense_0.weight",
                                    "density_mlp.dense_0.bias", "density_mlp.out.weight",
                                    "density_mlp.out.bias"}
    with torch.no_grad():
        got = tp(torch.as_tensor(x))
    assert got.shape == (500, 1)
    _close(got, want, 1e-5)


# -- the renders ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=[("prop", "hashgrid"), ("prop", "mxu"),
                                        ("plain", "hashgrid"), ("plain", "mxu")],
                ids=lambda p: "-".join(p))
def renders(request):
    """Both packages' renders of the same fields and rays: eval mode, and
    train mode on JAX's draws with the gradient of a seeded linear
    functional of every output (+ prop_loss) for every parameter."""
    kind, encoding = request.param
    jf = _jax_fields(encoding)
    params = _seeded_params(jf)
    o, d = _rays()
    rcfg_j, rcfg_t = JF.RenderConfig(**RCFG), TF.RenderConfig(**RCFG)
    key = jax.random.PRNGKey(7)

    want_eval = jax.jit(_jax_render(kind, jf, rcfg_j, False))(params, o, d, key)
    cot = _cotangents(want_eval)

    def loss(params):
        out = _jax_render(kind, jf, rcfg_j, True)(params, o, d, key)
        total = sum(jnp.sum(out[k] * cot[k]) for k in cot)
        return total + out.get("prop_loss", 0.0), out

    (_, want_train), want_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    fields = _port_fields(encoding, params)
    to = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    with torch.no_grad():
        got_eval = _port_render(kind, fields, to(o), to(d), rcfg_t, False, None)
    got_train = _port_render(kind, fields, to(o), to(d), rcfg_t, True,
                             tuple(map(to, _jax_draws(key, N_RAYS, rcfg_j))))
    total = sum((got_train[k] * to(cot[k])).sum() for k in cot)
    (total + got_train.get("prop_loss", 0.0)).backward()
    got_grad = {k: {n: p.grad for n, p in m.named_parameters()} for k, m in fields.items()}
    return dict(kind=kind, encoding=encoding, want_eval=want_eval, got_eval=got_eval,
                want_train=want_train, got_train=got_train, want_grad=want_grad,
                got_grad=got_grad)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_render_outputs_match_jax(renders, mode):
    want, got = renders[f"want_{mode}"], renders[f"got_{mode}"]
    keys = {"rgb", "accumulation", "depth", "weights", "feature"}
    if renders["kind"] == "prop":
        keys.add("prop_loss")
    assert set(want) == set(got) == keys
    tight = (renders["kind"], renders["encoding"]) == ("plain", "hashgrid")
    for k in keys:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        _close(got[k], want[k], TIGHT_RTOL if tight else OUT_RTOL, err_msg=k)


def test_render_gradients_match_jax(renders):
    """Every parameter tensor's gradient, relative to its own largest |JAX
    gradient|."""
    names = ("nerf", "feat", "prop") if renders["kind"] == "prop" else ("nerf", "feat")
    for name in names:
        want = TF.state_dict_from_jax(renders["want_grad"][name])
        got = renders["got_grad"][name]
        assert set(want) == set(got), name
        for k, g in got.items():
            assert g is not None, (name, k)
            if renders["encoding"] == "mxu" or (name, k) == ("prop", "grid.table"):
                rtol = GRAD_MXU_RTOL
            elif renders["kind"] == "plain":
                rtol = TIGHT_RTOL
            else:
                rtol = GRAD_RTOL
            _close(g, want[k], rtol, err_msg=f"{name}.{k}")


def test_rgb_loss_reaches_the_proposal_field():
    """The fine samples are not detached (JAX's PIXIE_DETACH_SAMPLES=0): the
    rgb alone moves every parameter of the proposal field (the gradients'
    values are held to JAX's above)."""
    fields = _port_fields("hashgrid", _seeded_params(_jax_fields("hashgrid"), seed=11))
    o, d = (torch.as_tensor(a) for a in _rays(16, seed=12))
    rcfg = TF.RenderConfig(**RCFG)
    draws = TF.draw_uniforms(16, rcfg, torch.Generator().manual_seed(0))
    _port_render("prop", fields, o, d, rcfg, True, draws, with_features=False)["rgb"].sum().backward()
    for k, p in fields["prop"].named_parameters():
        assert float(p.grad.abs().max()) > 0.0, k


def test_shipped_fields_render_matches_jax():
    """The shipped NerfField (MXU 16 x 2), FeatureField (12 x 8) and
    ProposalField in render_rays_prop, eval mode."""
    jf = _jax_fields("mxu", small=False, feature_dim=24)
    params = _seeded_params(jf, seed=20)
    for k in ("nerf", "feat"):       # tables nearer the trained scale: U(0, 0.1)
        params[k] = jax.tree_util.tree_map_with_path(
            lambda p, a: a * 0.1 if p[-1].key == "table" else a, params[k])
    o, d = _rays(32, seed=21)
    rcfg = dict(n_coarse=16, n_fine=16)
    want = jax.jit(_jax_render("prop", jf, JF.RenderConfig(**rcfg), False))(
        params, o, d, jax.random.PRNGKey(0))
    fields = _port_fields("mxu", params, small=False, feature_dim=24)
    with torch.no_grad():
        got = _port_render("prop", fields, torch.as_tensor(o), torch.as_tensor(d),
                           TF.RenderConfig(**rcfg), False, None)
    for k in want:
        _close(got[k], want[k], OUT_RTOL, err_msg=k)


def test_searchsorted_and_gathers_match_the_compare_counts():
    """``torch.searchsorted`` / ``torch.gather`` against JAX's dense
    compare-count and one-hot forms, with ties and out-of-range queries."""
    rng = np.random.default_rng(3)
    ref = np.sort(rng.uniform(0, 1, (40, 17)).astype(np.float32), axis=-1)
    q = np.concatenate([rng.uniform(-0.1, 1.1, (40, 9)), ref[:, 3:6]], -1).astype(np.float32)
    got = TF._searchsorted_right(torch.as_tensor(ref), torch.as_tensor(q))
    np.testing.assert_array_equal(to_np(got), np.asarray(JF._searchsorted_right(ref, q)))
    idx = np.clip(np.asarray(JF._searchsorted_right(ref, q)) - 1, 0, 16)
    np.testing.assert_array_equal(
        to_np(torch.gather(torch.as_tensor(ref), -1, torch.as_tensor(idx))),
        np.asarray(JF._gather_last(ref, idx)))
