"""The port reads and runs no file of the JAX package: an audit hook
(pixie_tpu_torch/utils/file_audit.py, installed in a subprocess, since a
hook cannot be removed) records every open of a path under pixie_tpu/ and
every child process whose arguments name one, while the port composes its
config, runs pipeline.main's capture stages, render.main's Blender modes and
render_pool.render_object against a recording ``blender``."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

from chip_smoke import blender_script, recording_blender
from test_torch_capture import seed_later_stages

REPO = Path(__file__).resolve().parent.parent

AUDITED_RUN = r"""
import json, sys
sys.path.insert(0, {repo!r})
from pixie_tpu_torch.utils.file_audit import watch_jax_package
found = watch_jax_package()
sys.modules["objaverse"] = None  # no download is ever tried

from pathlib import Path
from pixie_tpu_torch import pipeline, render
from pixie_tpu_torch.config import compose
from pixie_tpu_torch.data_curation import render_pool

base, obj, blender = Path({base!r}), "obj_audit", {blender!r}
over = [f"obj_id={{obj}}", f"paths.base_path={{base}}"]
compose()
compose(overrides=over + ["material_mode=vlm"])
pipeline.download_assets(base / "data" / "empty_obj", "empty_obj")
pipeline.main(over, device="cpu")
render.main(over + ["+render_modes=[blender_gs,blender_glb]"], device="cpu")
ok = render_pool.render_object({{"uid": obj, "glb": str(base / "data" / obj / "m.glb"),
                                 "output_dir": str(base / "pool" / obj), "gpu_id": 0,
                                 "blender_path": blender}})
print(json.dumps({{"found": found, "render_object": ok}}))
"""


def test_port_opens_and_runs_no_file_of_the_jax_package(tmp_path):
    base, obj = tmp_path / "base", "obj_audit"
    (base / "data" / obj).mkdir(parents=True)
    (base / "data" / obj / "m.glb").write_bytes(b"glTF")
    seed_later_stages(base, obj)
    blender = recording_blender(tmp_path / "bin")
    code = AUDITED_RUN.format(repo=str(REPO), base=str(base), blender=str(blender))
    env = {**os.environ, "PATH": f"{blender.parent}{os.pathsep}{os.environ['PATH']}"}
    # from the repository's root, where a relative path into pixie_tpu/ would resolve
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"found": [], "render_object": True}

    argvs = [json.loads(line) for line in (blender.parent / "argv.jsonl").read_text().splitlines()]
    scripts = [blender_script(a) for a in argvs]
    assert [s.name for s in scripts] == ["generate_blendernerf_data.py", "render_gs.py",
                                         "render_glb.py", "generate_blendernerf_data.py"]
    for s in scripts:
        assert s.is_file() and s.resolve().parent == (REPO / "pixie_tpu_torch" / "blender")


def test_the_hook_sees_a_read_and_a_run_of_the_jax_package(tmp_path):
    """The same hook records the JAX package's own reads: its compose()
    and the root render.py's Blender argv."""
    code = (f"import subprocess, sys\nsys.path.insert(0, {str(REPO)!r})\n"
            "from pixie_tpu_torch.utils.file_audit import watch_jax_package\n"
            "found = watch_jax_package()\n"
            "from pixie_tpu.config.core import load_yaml_tree\n"
            "found.clear()\n"
            f"load_yaml_tree({str(REPO / 'pixie_tpu' / 'conf' / 'config.yaml')!r})\n"
            "subprocess.run(['true', '-P', 'pixie_tpu/blender/render_gs.py'])\n"
            "subprocess.run('true pixie_tpu/blender/render_glb.py', shell=True)\n"
            "subprocess.run(['true'], cwd='pixie_tpu_torch')\n"
            "print(found)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    jax = str((REPO / "pixie_tpu").resolve())
    assert out.stdout.strip().splitlines()[-1] == str([
        f"{jax}/conf/config.yaml", f"subprocess.Popen: {jax}/blender/render_gs.py",
        f"subprocess.Popen: {jax}/blender/render_glb.py"])


def test_no_module_builds_a_path_into_the_jax_package():
    """No ``... / "pixie_tpu"`` and no ``"pixie_tpu/..."`` in the port, apart
    from file_audit.py, which names the directory it watches."""
    pattern = re.compile(r"""/\s*["']pixie_tpu["']|["']pixie_tpu/""")
    hits = [f"{p.relative_to(REPO)}:{i}" for p in sorted((REPO / "pixie_tpu_torch").rglob("*.py"))
            if p.name != "file_audit.py"
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line.split("#")[0])]
    assert hits == []
