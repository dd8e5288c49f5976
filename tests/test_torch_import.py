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
              "pixie_tpu_torch.models.unet3d", "pixie_tpu_torch.pipeline",
              "pixie_tpu_torch.ops.gs_stream", "pixie_tpu_torch.recon.rasterizer",
              "pixie_tpu_torch.sim.render_sim", "pixie_tpu_torch.recon.train_gaussians",
              "pixie_tpu_torch.recon.train_field", "pixie_tpu_torch.recon.colmap",
              "pixie_tpu_torch.utils.metrics", "pixie_tpu_torch.ops.fused_substep",
              "pixie_tpu_torch.config", "pixie_tpu_torch.config.core",
              "pixie_tpu_torch.ops.probe_ablation", "pixie_tpu_torch.ops.gather",
              "pixie_tpu_torch.scripts", "pixie_tpu_torch.scripts.timing",
              "pixie_tpu_torch.scripts.probe_kernel_ablation",
              "pixie_tpu_torch.scripts.probe_vmem_gather",
              "pixie_tpu_torch.recon.hashgrid", "pixie_tpu_torch.recon.mxu_hash",
              "pixie_tpu_torch.recon.field", "pixie_tpu_torch.recon.field_adapter",
              "pixie_tpu_torch.recon.tcnn_compat", "pixie_tpu_torch.voxel.voxelize",
              "pixie_tpu_torch.recon.clip_tower", "pixie_tpu_torch.recon.clip_features",
              "pixie_tpu_torch.train.trainer", "pixie_tpu_torch.train.data",
              "pixie_tpu_torch.train.inspect_ranges", "pixie_tpu_torch.train.inference",
              "pixie_tpu_torch.parallel", "pixie_tpu_torch.parallel.mesh"):
        assert m in MODULES


def test_no_jax_after_importing_every_module():
    assert _import_in_fresh_interpreter(MODULES) == []


@pytest.mark.parametrize("entry", ["pixie_tpu_torch.pipeline", "pixie_tpu_torch.sim.driver",
                                   "pixie_tpu_torch.recon.train_field",
                                   "pixie_tpu_torch.scripts.probe_kernel_ablation",
                                   "pixie_tpu_torch.scripts.probe_vmem_gather",
                                   "pixie_tpu_torch.train.trainer",
                                   "pixie_tpu_torch.train.inspect_ranges"])
def test_no_jax_from_entry_point(entry):
    assert _import_in_fresh_interpreter([entry]) == []


def test_pipeline_config_path_imports_no_jax_and_composes_the_same_tree():
    """pipeline.main's config path (compose, resolve_paths, get_output_paths)
    in a fresh interpreter loads nothing of JAX or the JAX package, and the
    port's compose() gives the tree pixie_tpu.config.compose() gives."""
    from pixie_tpu.config import compose as jax_compose

    overrides = ["obj_id=tree_0", "paths.base_path=/data", "physics.n_frames=2"]
    code = (
        "import json, sys\n"
        "import pixie_tpu_torch.pipeline\n"
        "from pixie_tpu_torch.config import compose\n"
        "from pixie_tpu_torch.utils.paths import get_output_paths, resolve_paths\n"
        f"cfg = compose(overrides={overrides!r})\n"
        "print(json.dumps(cfg.to_dict()))\n"
        "get_output_paths(resolve_paths(cfg), cfg.obj_id)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pixie_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tree, leaked = out.stdout.strip().splitlines()[-2:]
    assert json.loads(leaked) == []
    assert json.loads(tree) == json.loads(json.dumps(jax_compose(overrides=overrides).to_dict()))


def test_kernel_build_is_lazy():
    """Importing the kernel module builds nothing and needs no nvcc."""
    code = ("import pixie_tpu_torch.ops.transfer as t, pixie_tpu_torch.ops.build as b\n"
            "import pixie_tpu_torch.ops.gs_stream, pixie_tpu_torch.recon.rasterizer\n"
            "import pixie_tpu_torch.ops.fused_substep, pixie_tpu_torch.ops.probe_ablation\n"
            "import pixie_tpu_torch.ops.gather\n"
            "import pixie_tpu_torch.scripts.probe_kernel_ablation\n"
            "import pixie_tpu_torch.scripts.probe_vmem_gather\n"
            "assert not b._LIBS\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
