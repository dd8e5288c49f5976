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


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip: these tests run the hand-written kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")
