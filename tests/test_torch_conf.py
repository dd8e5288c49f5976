"""The port's YAML tree (pixie_tpu_torch/conf/) against the JAX package's
(pixie_tpu/conf/): the same files byte for byte, and ``compose`` giving the
same config for the same overrides, read from the port's own tree."""

from pathlib import Path

import pytest

from pixie_tpu.config import compose as jcompose
from pixie_tpu_torch.config import compose as tcompose
from pixie_tpu_torch.config import core as tcore

REPO = Path(__file__).resolve().parent.parent
JAX_CONF, TORCH_CONF = REPO / "pixie_tpu" / "conf", REPO / "pixie_tpu_torch" / "conf"


def _tree(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_the_same_files():
    assert _tree(TORCH_CONF) == _tree(JAX_CONF)
    assert len(_tree(TORCH_CONF)) == 11


@pytest.mark.parametrize("name", _tree(JAX_CONF))
def test_each_file_byte_equal(name):
    assert (TORCH_CONF / name).read_bytes() == (JAX_CONF / name).read_bytes()


def test_conf_dir_lies_in_the_port():
    conf = tcore.CONF_DIR.resolve()
    assert conf == TORCH_CONF.resolve()
    assert (REPO / "pixie_tpu_torch").resolve() in conf.parents


@pytest.mark.parametrize("overrides", [
    [],
    ["obj_id=tree_0", "paths.base_path=/data/objects"],
    ["material_mode=vlm"],
    ["physics.sample_id=2", "output_rendering.blender_render_gs.cycles_samples=32",
     "output_rendering.blender_render_gs.transparent=true"],
    ["data_rendering.num_views=12", "data_rendering.camera_dist_max=2.5",
     "data_rendering.resolution=128"],
], ids=["none", "obj_and_base", "vlm", "sample_and_blender_gs", "data_rendering"])
def test_compose_matches_jax(overrides):
    got, want = tcompose(overrides=overrides), jcompose(overrides=overrides)
    assert got == want
    assert tcompose(config_dir=TORCH_CONF, overrides=overrides) == want
