"""Headless Blender data generation (runs INSIDE Blender's python, not jax).

Copied from pixie_tpu/blender/generate_blendernerf_data.py.

Equivalent of pixie/blender/generate_blendernerf_data.py: normalize a GLB
to the unit cube, three-point studio lighting, place N cameras on random
spherical shells (distance 1.2-1.8, the reference's config/data_rendering
defaults), render PNGs with Cycles and emit a NeRF-style transforms.json.

Two camera paths:
  * default: manual sphere sampling, transforms.json written directly
    (no addon dependency);
  * --blender-nerf-addon-path <zip>: the reference's flow — install the
    BlenderNeRF addon and run its Camera-on-Sphere operator
    (generate_blendernerf_data.py:297-366), unpack the produced zip and
    write the dummy transforms_test.json.

Usage:
  blender --background --python pixie_tpu_torch/blender/generate_blendernerf_data.py -- \
      --glb <asset.glb> --out <data/obj_id> --num-views 200 \
      --dist-min 1.2 --dist-max 1.8 --resolution 512
"""

import argparse
import json
import math
import os
import random
import sys


def parse_args():
    argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else []
    ap = argparse.ArgumentParser()
    ap.add_argument("--glb", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-views", type=int, default=200)
    ap.add_argument("--dist-min", type=float, default=1.2)
    ap.add_argument("--dist-max", type=float, default=1.8)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--fov-deg", type=float, default=47.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--format", default="NERF", choices=["NERF", "NGP"])
    ap.add_argument("--scene-scale", type=float, default=1.0)
    ap.add_argument("--transparent-bg", action="store_true")
    ap.add_argument("--blender-nerf-addon-path", default=None,
                    help="BlenderNeRF addon zip; when given the addon's "
                    "Camera-on-Sphere operator renders (reference flow)")
    return ap.parse_args(argv)


def add_lighting():
    """Three-point studio lighting (reference :156-210)."""
    import bpy  # noqa: PLC0415

    for obj in list(bpy.data.objects):
        if obj.type == "LIGHT":
            bpy.data.objects.remove(obj, do_unlink=True)
    setups = [
        ("Key_Light", (2, -2, 2), 500, 5, (0.6, 0.2, 0.8)),
        ("Fill_Light", (-2, -1, 1), 200, 7, (0.5, -0.2, -0.8)),
        ("Rim_Light", (0, 2.5, 1.5), 300, 4, (-0.6, 0.0, 0.0)),
    ]
    for name, loc, energy, size, rot in setups:
        bpy.ops.object.light_add(type="AREA", location=loc)
        light = bpy.context.object
        light.name = name
        light.data.energy = energy
        light.data.size = size
        light.rotation_euler = rot


def render_with_addon(args, object_uid: str):
    """Reference addon flow: install BlenderNeRF, run Camera-on-Sphere
    (reference :297-366), unpack the zip it writes."""
    import json  # noqa: PLC0415
    import shutil  # noqa: PLC0415

    import bpy  # noqa: PLC0415

    bpy.ops.preferences.addon_install(
        filepath=args.blender_nerf_addon_path, overwrite=True)
    for mod in ("BlenderNeRF", "blendernerf", "blender_nerf"):
        try:
            bpy.ops.preferences.addon_enable(module=mod)
            break
        except Exception:  # noqa: BLE001
            continue

    scene = bpy.context.scene
    scene.train_data = True
    scene.test_data = False
    scene.aabb = 32
    scene.render_frames = True
    scene.nerf = args.format == "NERF"
    scene.save_path = args.out
    scene.cos_dataset_name = object_uid
    scene.sphere_location = (0.0, 0.0, 0.0)
    scene.sphere_rotation = (0.0, 0.0, 0.0)
    scene.sphere_scale = (1.0, 1.0, 1.0)
    if hasattr(scene, "sphere_radius_min"):
        scene.sphere_radius_min = args.dist_min / 2
        scene.sphere_radius_max = args.dist_max / 2
        scene.sphere_radius = (args.dist_min + args.dist_max) / 4
    else:
        scene.sphere_radius = (args.dist_min + args.dist_max) / 4
    scene.focal = 20.0
    scene.cos_nb_frames = args.num_views
    scene.seed = args.seed
    scene.upper_views = True
    scene.outwards = False
    try:
        bpy.ops.object.camera_on_sphere()
    except Exception as e:  # noqa: BLE001
        # harmless "BlenderNeRF Camera not found" fires after a complete
        # render (reference :349-355)
        if "BlenderNeRF Camera" not in str(e):
            raise
    zip_path = os.path.join(args.out, f"{object_uid}.zip")
    if os.path.exists(zip_path):
        shutil.unpack_archive(zip_path, args.out)
        os.remove(zip_path)
    if args.format == "NERF":
        with open(os.path.join(args.out, "transforms_test.json"), "w") as f:
            json.dump({"camera_angle_x": 0.0, "frames": []}, f)


def main():
    import bpy  # noqa: PLC0415  (only available inside Blender)
    from mathutils import Vector  # noqa: PLC0415

    args = parse_args()
    random.seed(args.seed)
    os.makedirs(args.out, exist_ok=True)

    # fresh scene
    bpy.ops.wm.read_factory_settings(use_empty=True)
    bpy.ops.import_scene.gltf(filepath=args.glb)

    # normalize union bbox to the unit cube centered at the origin
    meshes = [o for o in bpy.context.scene.objects if o.type == "MESH"]
    mins = Vector((1e9, 1e9, 1e9))
    maxs = Vector((-1e9, -1e9, -1e9))
    for o in meshes:
        for corner in o.bound_box:
            wc = o.matrix_world @ Vector(corner)
            mins = Vector(map(min, mins, wc))
            maxs = Vector(map(max, maxs, wc))
    center = (mins + maxs) / 2
    scale = args.scene_scale / max(max(maxs - mins), 1e-9)
    root = bpy.data.objects.new("pixie_root", None)
    bpy.context.scene.collection.objects.link(root)
    for o in bpy.context.scene.objects:
        if o is not root and o.parent is None:
            o.parent = root
    root.location = -center * scale
    root.scale = (scale, scale, scale)

    # camera + renderer
    cam_data = bpy.data.cameras.new("cam")
    cam_data.angle = math.radians(args.fov_deg)
    cam = bpy.data.objects.new("cam", cam_data)
    bpy.context.scene.collection.objects.link(cam)
    bpy.context.scene.camera = cam

    scene = bpy.context.scene
    scene.render.engine = "CYCLES"
    scene.cycles.samples = args.samples
    scene.render.resolution_x = scene.render.resolution_y = args.resolution
    scene.render.film_transparent = args.transparent_bg
    scene.render.image_settings.file_format = "PNG"
    scene.render.image_settings.color_mode = (
        "RGBA" if args.transparent_bg else "RGB")

    world = bpy.data.worlds.new("w")
    scene.world = world
    world.use_nodes = True
    world.node_tree.nodes["Background"].inputs[1].default_value = 1.0
    add_lighting()

    if args.blender_nerf_addon_path:
        uid = os.path.splitext(os.path.basename(args.glb))[0]
        render_with_addon(args, uid)
        print(f"addon-rendered {args.num_views} views -> {args.out}")
        return

    frames = []
    for i in range(args.num_views):
        # uniform direction on the sphere, random shell distance
        z = random.uniform(-1, 1)
        phi = random.uniform(0, 2 * math.pi)
        r = math.sqrt(max(1 - z * z, 0))
        d = random.uniform(args.dist_min, args.dist_max)
        pos = Vector((r * math.cos(phi) * d, r * math.sin(phi) * d, z * d))
        cam.location = pos
        look = -pos.normalized()
        cam.rotation_euler = look.to_track_quat("-Z", "Y").to_euler()
        bpy.context.view_layer.update()

        fname = f"r_{i:04d}.png"
        scene.render.filepath = os.path.join(args.out, fname)
        bpy.ops.render.render(write_still=True)
        frames.append(
            {
                "file_path": fname,
                "transform_matrix": [list(row) for row in cam.matrix_world],
            }
        )

    transforms = {"camera_angle_x": cam_data.angle, "frames": frames}
    with open(os.path.join(args.out, "transforms.json"), "w") as f:
        json.dump(transforms, f, indent=2)
    # the reference also writes transforms_train.json (BlenderNeRF layout)
    with open(os.path.join(args.out, "transforms_train.json"), "w") as f:
        json.dump(transforms, f, indent=2)
    print(f"rendered {args.num_views} views -> {args.out}")


if __name__ == "__main__":
    main()
