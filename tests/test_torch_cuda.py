"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (skipped without a GPU: a CUDA kernel has no CPU mode).

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: P2G sums float atomics in run-dependent order, so grids agree
to atol 1e-5 / rtol 1e-4 (momenta up to ~1e-1); G2P sums the 27 nodes in a
fixed order but contracts multiply-adds, atol 1e-5 / rtol 1e-4.  This file
imports no JAX package module.
"""

import numpy as np
import pytest
import torch

from torch_parity import cuda_device, random_particles, to_np  # noqa: F401  (fixture)

from pixie_tpu_torch.ops import transfer
from pixie_tpu_torch.sim.types import MPMConfig, finalize_mu_lam, make_state

pytestmark = pytest.mark.cuda
DT = 1e-4
G2P_FIELDS = ("x", "v", "C", "F_trial", "cov")


def _state(n=4096, seed=0):
    d = random_particles(n, seed)
    d["x"][:64] = np.float32(0.02)     # stencils hanging off the low faces
    d["x"][64:128] = np.float32(1.98)  # ... and the high faces
    st = finalize_mu_lam(make_state(d["x"], d["vol"], density=300.0, E=1e5, nu=0.35))
    rng = np.random.default_rng(seed + 1)
    return st.replace(
        v=torch.as_tensor(d["v"]), C=torch.as_tensor(d["C"]),
        stress=torch.as_tensor(d["stress"]),
        F=torch.as_tensor((np.eye(3) + 0.05 * rng.normal(size=(n, 3, 3))).astype(np.float32)),
        cov=torch.as_tensor(rng.normal(size=(n, 6)).astype(np.float32)),
        selection=torch.as_tensor((np.arange(n) % 13 == 0).astype(np.int32)))


def _to(st, dev, fields):
    return st.replace(**{k: getattr(st, k).to(dev).clone() for k in fields})


@pytest.mark.parametrize("rpic", [0.0, 0.2, -1.0])
def test_p2g_kernel_matches_plain(cuda_device, rpic):
    st = _state()
    cfg = MPMConfig(n_grid=24, grid_lim=2.0, rpic_damping=rpic)
    cpu = (st.x, st.v, st.C, st.stress, st.mass, st.vol, st.selection == 0)
    want = transfer.p2g_plain(*cpu, cfg, DT)
    before = transfer.P2G_LAUNCHES
    got = transfer.p2g(*(t.to(cuda_device) for t in cpu), cfg, DT)
    assert transfer.P2G_LAUNCHES == before + 1
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("update_cov", [False, True])
def test_g2p_kernel_matches_plain(cuda_device, update_cov):
    st = _state(seed=3)
    cfg = MPMConfig(n_grid=24, grid_lim=2.0, update_cov_with_F=update_cov)
    grid_v = torch.as_tensor(np.random.default_rng(2).normal(
        size=(24, 24, 24, 3)).astype(np.float32))
    want = transfer.g2p_plain(_to(st, "cpu", G2P_FIELDS), grid_v, cfg, DT)
    before = transfer.G2P_LAUNCHES
    got = transfer.g2p(_to(st, cuda_device, G2P_FIELDS + ("F", "selection")),
                       grid_v.to(cuda_device), cfg, DT)
    assert transfer.G2P_LAUNCHES == before + 1
    for k in G2P_FIELDS:
        np.testing.assert_allclose(to_np(getattr(got, k)), to_np(getattr(want, k)),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    st = _to(_state(n=256), cuda_device, G2P_FIELDS + ("F", "stress", "mass", "vol", "selection"))
    cfg = MPMConfig(n_grid=24, grid_lim=2.0)
    active = st.selection == 0
    with pytest.raises(TypeError):
        transfer.p2g(st.x.double(), st.v, st.C, st.stress, st.mass, st.vol, active, cfg, DT)
    with pytest.raises(ValueError, match="contiguous"):
        transfer.p2g(st.x, st.v, st.C.transpose(1, 2), st.stress, st.mass, st.vol, active,
                     cfg, DT)
    with pytest.raises(ValueError, match="expected cuda"):
        transfer.p2g(st.x, st.v.cpu(), st.C, st.stress, st.mass, st.vol, active, cfg, DT)
    with pytest.raises(ValueError, match="shape"):
        transfer.g2p(st, torch.zeros((8, 8, 8, 3), device=cuda_device), cfg, DT)
