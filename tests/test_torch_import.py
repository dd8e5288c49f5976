"""Importing any pixie_tpu_torch module must not import JAX or flax, nor
the JAX package itself (``chip_smoke.py`` runs on a machine without JAX)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in (REPO / "pixie_tpu_torch").rglob("*.py")
)


def _import_in_fresh_interpreter(modules):
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pixie_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_module_list_covers_the_slice():
    for m in ("pixie_tpu_torch.ops.transfer", "pixie_tpu_torch.sim.driver",
              "pixie_tpu_torch.models.unet3d", "pixie_tpu_torch.pipeline"):
        assert m in MODULES


def test_no_jax_after_importing_every_module():
    assert _import_in_fresh_interpreter(MODULES) == []


@pytest.mark.parametrize("entry", ["pixie_tpu_torch.pipeline", "pixie_tpu_torch.sim.driver"])
def test_no_jax_from_entry_point(entry):
    assert _import_in_fresh_interpreter([entry]) == []


def test_kernel_build_is_lazy():
    """Importing the kernel module builds nothing and needs no nvcc."""
    code = ("import pixie_tpu_torch.ops.transfer as t, pixie_tpu_torch.ops.build as b\n"
            "assert not b._LIBS\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
