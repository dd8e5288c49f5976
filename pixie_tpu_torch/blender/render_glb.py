"""Blender turntable/capture-view renderer for GLB meshes.

Copied from pixie_tpu/blender/render_glb.py.

Runs INSIDE Blender (``blender -b -P render_glb.py -- <args>``); gated on
the binary.  Behavior-equivalent slim rebuild of the reference
pixie/blender/render_glb.py:1-422: import the (feature-colored) GLB,
normalize it into the unit scene (uniform scale, optional raise-to-ground),
render either N turntable views or the capture camera from
``transforms.json``, Cycles, optional transparent film.

Used for the ``blender_glb`` render mode on the artifacts
utils/mesh_paint.py produces (painted_mesh.glb) or the raw dataset GLB.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

try:
    import bpy
    from mathutils import Matrix, Vector
except ImportError as e:  # pragma: no cover - requires the Blender binary
    raise SystemExit("render_glb.py must run inside Blender (blender -b -P)") from e


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--obj", required=True, help="path to the .glb to render")
    p.add_argument("--obj_id", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--blend_file_path", default=None)
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--resolution", type=int, default=800)
    p.add_argument("--scene_scale", type=float, default=1.0)
    p.add_argument("--transparent", action="store_true")
    p.add_argument("--camera_id", type=int, default=None)
    p.add_argument("--focal_length", type=float, default=None)
    p.add_argument("--data_dir", default=None,
                   help="capture dir holding <obj_id>/transforms.json")
    p.add_argument("--cycles_samples", type=int, default=64)
    argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else []
    return p.parse_args(argv)


def mesh_objects():
    return [o for o in bpy.context.scene.objects if o.type == "MESH"]


def scene_bbox(objs):
    lo = Vector((1e9, 1e9, 1e9))
    hi = Vector((-1e9, -1e9, -1e9))
    for o in objs:
        for c in o.bound_box:
            w = o.matrix_world @ Vector(c)
            lo = Vector(map(min, lo, w))
            hi = Vector(map(max, hi, w))
    return lo, hi


def normalize_scene(objs, scene_scale=1.0, raise_to_ground=True):
    """Uniformly scale the import to a unit box centered at the origin."""
    lo, hi = scene_bbox(objs)
    scale = scene_scale / max(max(hi - lo), 1e-9)
    offset = -(lo + hi) / 2
    for o in objs:
        if o.parent is None:
            o.matrix_world = (
                Matrix.Scale(scale, 4)
                @ Matrix.Translation(offset)
                @ o.matrix_world
            )
    bpy.context.view_layer.update()
    if raise_to_ground:
        lo, _ = scene_bbox(objs)
        for o in objs:
            if o.parent is None:
                o.location.z -= lo.z
        bpy.context.view_layer.update()


def apply_capture_camera(cam, tf_path: Path, cam_id, focal):
    tf = json.loads(tf_path.read_text())
    frame = tf["frames"][cam_id if cam_id is not None else 0]
    cam.matrix_world = Matrix(frame["transform_matrix"])
    w = tf.get("w", bpy.context.scene.render.resolution_x)
    fl_x = tf.get("fl_x")
    if fl_x:
        cam.data.lens_unit = "FOV"
        cam.data.angle = 2 * math.atan(w / (2 * fl_x))
    if focal:
        cam.data.lens = focal


def main():
    args = parse_args()
    out = Path(args.output_folder)
    out.mkdir(parents=True, exist_ok=True)

    if args.blend_file_path:
        bpy.ops.wm.open_mainfile(filepath=args.blend_file_path)
    scene = bpy.context.scene
    scene.render.engine = "CYCLES"
    scene.cycles.samples = args.cycles_samples
    scene.render.resolution_x = args.resolution
    scene.render.resolution_y = args.resolution
    scene.render.film_transparent = args.transparent
    scene.render.image_settings.color_mode = (
        "RGBA" if args.transparent else "RGB"
    )

    bpy.ops.import_scene.gltf(filepath=args.obj)
    normalize_scene(mesh_objects(), args.scene_scale)

    cam = scene.camera
    if cam is None:
        bpy.ops.object.camera_add()
        cam = bpy.context.active_object
        scene.camera = cam

    tf_path = (Path(args.data_dir) / args.obj_id / "transforms.json"
               if args.data_dir else Path("nonexistent"))
    if args.camera_id is not None and tf_path.exists():
        apply_capture_camera(cam, tf_path, args.camera_id, args.focal_length)
        scene.render.filepath = str(out / f"{args.obj_id}_cam.png")
        bpy.ops.render.render(write_still=True)
        return

    # turntable: orbit the camera around the grounded object
    pivot = Vector((0.0, 0.0, 0.35))
    for vi in range(args.views):
        theta = 2 * math.pi * vi / args.views
        cam.location = pivot + Vector(
            (2.0 * math.cos(theta), 2.0 * math.sin(theta), 0.8))
        direction = pivot - cam.location
        cam.rotation_euler = direction.to_track_quat("-Z", "Y").to_euler()
        scene.render.filepath = str(out / f"{args.obj_id}_{vi:03d}.png")
        bpy.ops.render.render(write_still=True)


if __name__ == "__main__":
    main()
