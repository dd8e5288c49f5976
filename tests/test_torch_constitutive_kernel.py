"""The constitutive pass's dispatch (``ops.constitutive.constitutive_pass``)
and, on the card, its kernel (B7, ``csrc/constitutive.cu``) against the
plain pass ``sim.constitutive.compute_stress_from_F_trial``.

On the CPU the pass is the plain pass, bit for bit, and the solver reaches
it through ``constitutive_pass`` on the unfused substep and the fused
frame's prologue.  On the card (tests marked ``cuda``, skipped without a
GPU: a CUDA kernel has no CPU mode; ``python -m pytest
tests/test_torch_constitutive_kernel.py -m cuda``) F, stress, mu, lam and
the yield stress are held to the part of B6's criterion that
``chip_smoke._check_fused`` applies to these five fields: 90 % of entries
within the float32 ULP floor 6 * 1.2e-7 * scale (scale E for stress, the
field's largest finite |value| otherwise), all within 100 times it; the
kernel contracts multiply-adds where the plain version rounds each op, and
stress = 2 mu (F - R) F^T with F near I amplifies last-ulp differences of
F.  This file imports no JAX package module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import cuda_device, to_np  # noqa: F401  (fixture)

from pixie_tpu_torch.ops import constitutive as ops_const
from pixie_tpu_torch.ops import fused_substep as fs
from pixie_tpu_torch.sim import solver as tsolver
from pixie_tpu_torch.sim.constitutive import compute_stress_from_F_trial
from pixie_tpu_torch.sim.types import MPMConfig, MPMState, finalize_mu_lam, make_state

DT = 1e-4
E = 9e6
OUTPUTS = ("F", "stress", "mu", "lam", "yield_stress")
ULP_FLOOR, ULP_SHARE, ULP_MAX = 6 * 1.2e-7, 0.9, 100.0


def _mixed_state(n=800, seed=3):
    """ids 0-7 in turn, F_trial = I + 0.02 noise (sand expands and
    compacts), yield stresses low enough that von Mises and snow yield,
    every 8th near 0 (snow damages), every 11th particle inactive, and F and
    stress unlike what the pass writes, so that a row it should keep shows."""
    rng = np.random.default_rng(seed)
    ys = rng.uniform(1e3, 1e5, n).astype(np.float32)
    ys[::8] = 1e-3
    st = finalize_mu_lam(make_state(
        rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32), np.full(n, 1e-6, np.float32),
        density=600.0, E=E, nu=0.33, material=(np.arange(n) % 8).astype(np.int32),
        yield_stress=ys, bulk=2e6))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    s = 1e3 * rng.normal(size=(n, 3, 3))
    return st.replace(F_trial=t(np.eye(3) + 0.02 * rng.normal(size=(n, 3, 3))),
                      F=t(np.eye(3) + 0.05 * rng.normal(size=(n, 3, 3))),
                      stress=t(0.5 * (s + np.swapaxes(s, 1, 2))),
                      selection=torch.as_tensor((np.arange(n) % 11 == 4).astype(np.int32)))


def _cfg(mats):
    return MPMConfig(n_grid=16, grid_lim=2.0, active_materials=tuple(mats), hardening=1.0,
                     xi=0.1, plastic_viscosity=0.1, softening=0.5, friction_angle=30.0)


def _fields(st):
    return {k: getattr(st, k).clone() for k in ("F_trial",) + OUTPUTS}


# -- CPU: dispatch ------------------------------------------------------------------------------

@pytest.mark.parametrize("mats", [tuple(range(8)), (0, 2, 5), (1, 3, 6)])
def test_cpu_pass_is_the_plain_pass_bit_for_bit(mats):
    """A mixed state of ids 0-7 with inactive rows, under every material set
    and two subsets of it: the plain pass's five fields exactly, no launch
    counted, the caller's tensors left as they were."""
    st = _mixed_state()
    cfg = _cfg(mats)
    before = _fields(st)
    launches = ops_const.CONSTITUTIVE_LAUNCHES
    got = ops_const.constitutive_pass(st, cfg, DT)
    assert ops_const.CONSTITUTIVE_LAUNCHES == launches
    want = compute_stress_from_F_trial(_mixed_state(), cfg, DT)
    for k in OUTPUTS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k, t in before.items():
        assert torch.equal(getattr(st, k), t), k
    inactive = st.selection != 0
    assert torch.equal(got.F[inactive], st.F[inactive])
    assert not torch.equal(got.F, st.F)      # the active rows did change


@pytest.mark.parametrize("fused", [False, True])
def test_solver_reaches_the_pass_through_the_wrapper(monkeypatch, fused):
    """``_substep`` calls ``constitutive_pass`` once a substep, the fused
    frame once, in its prologue (its substeps run B6's plain version, which
    calls the plain pass itself); the frame's state is the one the wrapper
    returned, unchanged by the spy."""
    st = _mixed_state(n=200, seed=5)
    cfg = _cfg(range(8))
    calls = []
    real = ops_const.constitutive_pass

    def spy(state, c, dt):
        calls.append(state.n_particles)
        return real(state, c, dt)

    frame = tsolver.simulate_substeps_fused if fused else tsolver.simulate_substeps
    want = frame(_mixed_state(n=200, seed=5), cfg, (), 0.0, DT, 5)
    monkeypatch.setattr(ops_const, "constitutive_pass", spy)
    got = frame(st, cfg, (), 0.0, DT, 5)
    assert calls == [200] * (1 if fused else 5)
    for k in ("x", "v") + OUTPUTS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_pass_refuses_other_devices():
    st = _mixed_state(n=16)
    meta = MPMState(**{k: v.to("meta") for k, v in vars(st).items()})
    with pytest.raises(ValueError, match="unsupported device"):
        ops_const.constitutive_pass(meta, _cfg(range(8)), DT)


# -- the card: B7 against the plain pass --------------------------------------------------------

def _card_state(n, degenerate=True):
    """chip_smoke's B6 state (ids 0, 1, 2, 3, 5, 6 in turn; yielding, sand
    expanding and compacting, snow damaging, every 13th inactive) with, if
    ``degenerate``, degenerate F_trial on six consecutive rows each, so
    every material meets them: the identity, one singular value exactly 0,
    det F < 0 (a reflection, and a rotated one).  Where the plain pass gives
    NaN (Drucker-Prager's log of a zero or negative singular value) the
    kernel must too.  n >= 1000."""
    from chip_smoke import _fused_state

    st, cfg, _ = _fused_state(torch.device("cpu"), n=n, n_grid=24)
    if not degenerate:
        return st, cfg
    rng = np.random.default_rng(9)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot *= np.sign(np.linalg.det(rot))
    degenerate = [np.eye(3), np.diag([1.2, 0.9, 0.0]), np.diag([1.1, 0.95, -1.02]),
                  rot @ np.diag([1.05, -0.97, 1.01]) @ rot.T]
    ft = st.F_trial.clone()
    for i, m in enumerate(degenerate):
        ft[60 + 6 * i:66 + 6 * i] = torch.as_tensor(m.astype(np.float32))
    # F differs from F_trial, so that the copy of an inactive row shows
    return st.replace(F_trial=ft, F=(st.F + 0.01).contiguous()), cfg


def _to(st, dev, offset=0):
    """Every field on ``dev``; with ``offset``, views from row ``offset``
    of one row more, so that the (N, 3, 3) arrays start off a 16-byte
    boundary (36-byte rows)."""
    out = {}
    for k, t in vars(st).items():
        if offset:
            t = torch.cat([t[:offset], t])
        out[k] = t.to(dev).clone()[offset:]
    return MPMState(**out)


def _assert_b7_close(got, want, label):
    for k in OUTPUTS:
        g, w = to_np(getattr(got, k)), to_np(getattr(want, k))
        same = (g == w) | (np.isnan(g) & np.isnan(w))
        diff = np.where(same, 0.0, np.abs(g.astype(np.float64) - w))
        finite = np.abs(w[np.isfinite(w)])
        scale = E if k == "stress" else max(float(finite.max()), 1e-30)
        floor = ULP_FLOOR * scale
        assert (diff <= floor).mean() >= ULP_SHARE, f"{k} ({label})"
        assert diff.max() <= ULP_MAX * floor, f"{k} ({label}): {diff.max()} > {ULP_MAX * floor}"


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_constitutive_kernel_matches_plain(cuda_device, offset):
    """B7 through ``constitutive_pass`` on 4133 particles (a last block of
    37) against the plain pass on the CPU: every return-map branch taken,
    inactive rows copied exactly, the input tensors untouched, one launch
    counted a call."""
    from chip_smoke import _branches

    st, cfg = _card_state(4133)
    want = compute_stress_from_F_trial(st, cfg, DT)
    bp = to_np(_branches(want, st.mu))
    assert all((bp == c).any() for c in (1, 3, 5)), "a return-map branch was not taken"
    dev_st = _to(st, cuda_device, offset)
    before = {k: t.clone() for k, t in vars(dev_st).items()}
    launches = ops_const.CONSTITUTIVE_LAUNCHES
    got = ops_const.constitutive_pass(dev_st, cfg, DT)
    assert ops_const.CONSTITUTIVE_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    _assert_b7_close(got, want, f"offset {offset}")
    for k, t in before.items():
        assert torch.equal(getattr(dev_st, k), t), k
    inactive = to_np(st.selection) != 0
    for k in OUTPUTS:
        np.testing.assert_array_equal(to_np(getattr(got, k))[inactive],
                                      to_np(getattr(st, k))[inactive], err_msg=k)
    for k in ("x", "v", "C", "F_trial", "material", "selection"):
        assert getattr(got, k) is getattr(dev_st, k), k


@pytest.mark.cuda
@pytest.mark.parametrize("mats", [(0,), (1,), (2,), (3,), (4,), (5,), (6,), (7,), (2, 3, 5)])
def test_constitutive_kernel_one_material_set(cuda_device, mats):
    """Each material alone (``active_materials`` of that id) and config 5's
    three, on the card state's materials: ids outside the set take no
    branch, as in the plain pass."""
    st, cfg = _card_state(1024)
    cfg = dataclasses.replace(cfg, active_materials=mats)
    want = compute_stress_from_F_trial(st, cfg, DT)
    got = ops_const.constitutive_pass(_to(st, cuda_device), cfg, DT)
    _assert_b7_close(got, want, f"active {mats}")


@pytest.mark.cuda
def test_frames_on_cuda_launch_b7(cuda_device):
    """An unfused frame of S substeps runs B7 S times, a fused frame once
    (its prologue).  The unfused frame replays its substep as a CUDA graph:
    its B7 runs are the wrapper's launches, less the graphs' captures (a
    wrapper call that records the launch), plus their replays."""
    st, cfg = _card_state(2048, degenerate=False)
    for frame, want in ((tsolver.simulate_substeps, 6), (tsolver.simulate_substeps_fused, 1)):
        before = (ops_const.CONSTITUTIVE_LAUNCHES, fs.FUSED_LAUNCHES, tsolver.GRAPH_CAPTURES,
                  tsolver.GRAPH_REPLAYS)
        out = frame(_to(st, cuda_device), cfg, (), 0.0, DT, 6)
        torch.cuda.synchronize()
        launches, fused, captures, replays = (a - b for a, b in zip(
            (ops_const.CONSTITUTIVE_LAUNCHES, fs.FUSED_LAUNCHES, tsolver.GRAPH_CAPTURES,
             tsolver.GRAPH_REPLAYS), before))
        assert launches - captures + replays == want
        assert fused == (5 if want == 1 else 0)
        assert bool(torch.isfinite(out.x).all())


@pytest.mark.cuda
def test_constitutive_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    st, cfg = _card_state(1024)
    st = _to(st, cuda_device)
    with pytest.raises(TypeError):
        ops_const.constitutive_pass(st.replace(F_trial=st.F_trial.double()), cfg, DT)
    with pytest.raises(ValueError, match="contiguous"):
        ops_const.constitutive_pass(st.replace(F_trial=st.F_trial.transpose(1, 2)), cfg, DT)
    with pytest.raises(ValueError, match="expected cuda"):
        ops_const.constitutive_pass(st.replace(mu=st.mu.cpu()), cfg, DT)
    with pytest.raises(TypeError):
        ops_const.constitutive_pass(st.replace(selection=st.selection.bool()), cfg, DT)
    with pytest.raises(ValueError, match="shape"):
        ops_const.constitutive_pass(st.replace(lam=st.lam[:-1]), cfg, DT)
