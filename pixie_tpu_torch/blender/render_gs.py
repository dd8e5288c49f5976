"""Blender batch renderer for simulated 3DGS frame PLYs.

Copied from pixie_tpu/blender/render_gs.py.

Runs INSIDE Blender (``blender -b -P render_gs.py -- <args>``); gated on the
binary like generate_blendernerf_data.py.  Behavior-equivalent slim rebuild
of the reference pixie/blender/render_gs.py:1-600: install/enable the
Gaussian-Splatting import addon, import each ``frame_*.ply`` from the sim
output's ply_files dir, position the splat (rotate -> shift -> optional
ground drop), apply a camera from the capture ``transforms.json`` (or an
orbit), render with Cycles, and compile the frames to a video.

Artifact contract: consumes exactly what pixie_tpu.sim.driver writes
(``sample_k/ply_files/frame_%04d.ply``) plus the BlenderNeRF capture's
``transforms.json`` — so reference and rebuild outputs are interchangeable.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

try:
    import bpy
    from mathutils import Matrix
except ImportError as e:  # pragma: no cover - requires the Blender binary
    raise SystemExit("render_gs.py must run inside Blender (blender -b -P)") from e


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--obj_id", required=True)
    p.add_argument("--ply_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--blend_file_path", default=None)
    p.add_argument("--blender_gs_addon_path", required=True)
    p.add_argument("--frame_id", type=int, default=None)
    p.add_argument("--camera_id", type=int, default=None)
    p.add_argument("--rotate_around", type=float, default=None,
                   help="orbit degrees/frame instead of a fixed capture camera")
    p.add_argument("--focal_length_ratio", type=float, default=None)
    p.add_argument("--init_xyz", nargs=3, type=float, default=(0.0, 0.0, 0.0))
    p.add_argument("--xyz_rotation", nargs=3, type=float, default=(0.0, 0.0, 0.0))
    p.add_argument("--place_on_ground", action="store_true")
    p.add_argument("--is_dropping", action="store_true",
                   help="ground using frame 0's bounds for all frames")
    p.add_argument("--transparent", action="store_true")
    p.add_argument("--resolution_x", type=int, default=800)
    p.add_argument("--resolution_y", type=int, default=800)
    p.add_argument("--cycles_samples", type=int, default=64)
    p.add_argument("--num_renders", type=int, default=None)
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--save_blend", action="store_true")
    p.add_argument("--bg_color", nargs="+", type=float, default=None)
    p.add_argument("--overwrite", action="store_true")
    argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else []
    return p.parse_args(argv)


def enable_accelerators():
    """Prefer GPU compute when the host has one; fall back to CPU."""
    prefs = bpy.context.preferences.addons["cycles"].preferences
    prefs.get_devices()
    for kind in ("CUDA", "OPENCL", "NONE"):
        try:
            prefs.compute_device_type = kind
            break
        except TypeError:
            continue
    accelerated = any(d.type in ("CUDA", "OPENCL") for d in prefs.devices)
    for d in prefs.devices:
        d.use = (not accelerated) or d.type in ("CUDA", "OPENCL")
    return accelerated


def ensure_gs_addon(zip_path: str):
    import addon_utils

    mod = "blender-addon"
    if any(m.__name__ == mod for m in addon_utils.modules()):
        try:
            bpy.ops.preferences.addon_enable(module=mod)
            return
        except Exception:  # noqa: BLE001 - reinstall below
            bpy.ops.preferences.addon_remove(module=mod)
    bpy.ops.preferences.addon_install(filepath=zip_path, overwrite=True)
    bpy.ops.preferences.addon_enable(module=mod)


def apply_capture_camera(cam, transforms_path: Path, cam_id: int,
                         focal_ratio: float | None):
    tf = json.loads(transforms_path.read_text())
    frame = tf["frames"][cam_id if cam_id is not None else 0]
    cam.matrix_world = Matrix(frame["transform_matrix"])
    w = tf.get("w", bpy.context.scene.render.resolution_x)
    fl_x = tf.get("fl_x")
    if fl_x:
        cam.data.lens_unit = "FOV"
        cam.data.angle = 2 * math.atan(w / (2 * fl_x))
    if focal_ratio:
        cam.data.lens *= focal_ratio


def orbit_camera(cam, deg_per_frame: float, frame_idx: int):
    """Rotate the camera about the world z-axis through the origin."""
    rot = Matrix.Rotation(math.radians(deg_per_frame * frame_idx), 4, "Z")
    cam.matrix_world = rot @ cam.matrix_world


def position_object(obj, init_xyz, xyz_rotation_deg, ground: bool,
                    ground_bounds=None):
    obj.rotation_euler = [math.radians(a) for a in xyz_rotation_deg]
    bpy.context.view_layer.update()
    obj.location.x += init_xyz[0]
    obj.location.y += init_xyz[1]
    obj.location.z += init_xyz[2]
    bpy.context.view_layer.update()
    if ground:
        corners = ground_bounds if ground_bounds is not None else [
            obj.matrix_world @ Matrix.Translation(c).to_translation()
            for c in obj.bound_box
        ]
        low_z = min(c.z for c in corners)
        obj.location.z -= low_z
        bpy.context.view_layer.update()
    return [obj.matrix_world @ Matrix.Translation(c).to_translation()
            for c in obj.bound_box]


def setup_scene(args):
    if args.blend_file_path:
        bpy.ops.wm.open_mainfile(filepath=args.blend_file_path)
    ensure_gs_addon(args.blender_gs_addon_path)
    enable_accelerators()
    scene = bpy.context.scene
    scene.render.engine = "CYCLES"
    scene.cycles.samples = args.cycles_samples
    scene.render.resolution_x = args.resolution_x
    scene.render.resolution_y = args.resolution_y
    scene.render.film_transparent = args.transparent
    scene.render.image_settings.color_mode = (
        "RGBA" if args.transparent else "RGB"
    )
    if args.bg_color and not args.transparent and scene.world:
        def srgb_to_linear(c):
            return c / 12.92 if c <= 0.04045 else ((c + 0.055) / 1.055) ** 2.4

        scene.world.use_nodes = True
        bg = scene.world.node_tree.nodes.get("Background")
        if bg is not None:
            rgba = list(args.bg_color) + [1.0] * (4 - len(args.bg_color))
            bg.inputs[0].default_value = [
                srgb_to_linear(c) for c in rgba[:3]
            ] + [rgba[3]]


def render_frame(args, ply: Path, out_png: Path, frame_idx: int,
                 ground_bounds=None):
    bpy.ops.object.import_gaussian_splatting(filepath=str(ply.resolve()))
    obj = bpy.context.selected_objects[0] if bpy.context.selected_objects \
        else bpy.context.active_object
    bounds = position_object(
        obj, args.init_xyz, args.xyz_rotation, args.place_on_ground,
        ground_bounds,
    )

    cam = bpy.context.scene.camera
    if cam is None:
        bpy.ops.object.camera_add(location=(0.0, -3.0, 1.5),
                                  rotation=(math.radians(72), 0, 0))
        cam = bpy.context.active_object
        bpy.context.scene.camera = cam
    tf_path = Path(args.data_dir) / args.obj_id / "transforms.json"
    if args.rotate_around is not None:
        orbit_camera(cam, args.rotate_around, frame_idx)
    elif tf_path.exists():
        apply_capture_camera(cam, tf_path, args.camera_id,
                             args.focal_length_ratio)

    bpy.context.scene.render.filepath = str(out_png)
    bpy.ops.render.render(write_still=True)
    if args.save_blend:
        bpy.ops.wm.save_as_mainfile(
            filepath=str(out_png.with_suffix(".blend")))
    bpy.data.objects.remove(obj, do_unlink=True)
    return bounds


def compile_video(img_dir: Path, fps: int, out_name: str = "output.mp4"):
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
           "-i", str(img_dir / "*.png"), "-c:v", "libx264",
           "-pix_fmt", "yuv420p", str(img_dir / out_name)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"video compile skipped: {e}")


def main():
    args = parse_args()
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    setup_scene(args)

    plys = sorted(Path(args.ply_dir).glob("frame_*.ply"))
    if args.frame_id is not None:
        plys = [p for p in plys if f"{args.frame_id:04d}" in p.stem]
    plys = plys[args.start_frame:]
    if args.num_renders is not None:
        plys = plys[:args.num_renders]

    ground_bounds = None
    for i, ply in enumerate(plys):
        out_png = out_dir / f"{ply.stem}.png"
        if out_png.exists() and not args.overwrite:
            continue
        bounds = render_frame(args, ply, out_png, i, ground_bounds)
        if args.is_dropping and ground_bounds is None:
            # dropping sims keep frame 0's grounding offset for all frames
            ground_bounds = bounds

    if args.frame_id is None and len(plys) > 1:
        compile_video(out_dir, args.fps)


if __name__ == "__main__":
    main()
