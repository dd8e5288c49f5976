"""Parallel Blender render farm for curated Objaverse assets.

Copied from pixie_tpu/data_curation/render_pool.py (host only); the jobs
run the port's own bpy script, and ``run_cmd`` is the port's.

Rebuild of the reference's GPU-parallel render pool
(data_curation/render_objaverse_classes.py:12-73): a ProcessPoolExecutor
fans N workers over the curated {class: [uids]} dict, each shelling out to
``blender -b -P pixie_tpu_torch/blender/generate_blendernerf_data.py`` with a
per-worker accelerator pin (CUDA_VISIBLE_DEVICES round-robin: Blender
Cycles renders on the GPUs), idempotent skip
of already-rendered objects, and per-job timeouts.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from pathlib import Path

_BLENDER_SCRIPT = str(
    Path(__file__).parent.parent / "blender" / "generate_blendernerf_data.py"
)


def render_object(job: dict) -> bool:
    """One object: skip when PNGs exist, else run Blender headless."""
    from pixie_tpu_torch.utils.proc import CommandError, run_cmd  # noqa: PLC0415

    out_dir = job["output_dir"]
    if glob.glob(f"{out_dir}/*.png"):
        return True
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ)
    if job.get("gpu_id") is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(job["gpu_id"])
    cmd = [
        job.get("blender_path", "blender"), "-b", "-P", _BLENDER_SCRIPT, "--",
        "--glb", job["glb"], "--out", out_dir,
        "--num-views", str(job.get("views", 200)),
        "--resolution", str(job.get("resolution", 512)),
    ]
    try:
        run_cmd(cmd, env=env, echo=False)
        return True
    except (CommandError, OSError) as e:
        logging.warning("render failed for %s: %s", job["glb"], e)
        return False


def build_render_jobs(
    dataset: dict[str, list[str]],
    glb_dir: str | Path,
    render_outputs_dir: str | Path,
    obj_class: str | None = None,
    max_objs_per_class: int | None = None,
    num_gpus: int = 1,
    blender_path: str = "blender",
    resolution: int = 512,
    views: int = 200,
) -> list[dict]:
    """{class: [uids]} -> job dicts with round-robin GPU assignment."""
    classes = [obj_class] if obj_class else sorted(dataset)
    jobs = []
    for cls in classes:
        uids = dataset[cls]
        if max_objs_per_class:
            uids = uids[:max_objs_per_class]
        for i, uid in enumerate(uids):
            jobs.append({
                "uid": uid,
                "glb": str(Path(glb_dir) / f"{uid}.glb"),
                "output_dir": str(Path(render_outputs_dir) / cls / uid),
                "gpu_id": i % num_gpus if num_gpus > 0 else None,
                "blender_path": blender_path,
                "resolution": resolution,
                "views": views,
            })
    return jobs


def render_pool(jobs: list[dict], num_workers: int = 4,
                timeout: float = 1800.0,
                worker_fn=render_object) -> list[bool]:
    """Run jobs over a process pool; False for failed/timed-out jobs."""
    logging.info("rendering %d objects over %d workers", len(jobs),
                 num_workers)
    results = []
    with ProcessPoolExecutor(max_workers=num_workers) as ex:
        futures = [ex.submit(worker_fn, j) for j in jobs]
        for fut, job in zip(futures, jobs):
            try:
                results.append(bool(fut.result(timeout=timeout)))
            except FutureTimeout:
                logging.warning("render %s timed out after %.0fs",
                                job["uid"], timeout)
                results.append(False)
            except Exception as e:  # noqa: BLE001
                logging.warning("render %s crashed: %s", job["uid"], e)
                results.append(False)
    logging.info("rendered %d/%d successfully", sum(results), len(results))
    return results


def main(argv=None):
    import argparse  # noqa: PLC0415

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True,
                    help="JSON {class: [uids]} (curation.save_cat_dict)")
    ap.add_argument("--glb-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--obj-class", default=None)
    ap.add_argument("--max-objs-per-class", type=int, default=None)
    ap.add_argument("--num-gpus", type=int, default=1)
    ap.add_argument("--jobs-per-gpu", type=int, default=1)
    ap.add_argument("--blender-path", default="blender")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--views", type=int, default=200)
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    dataset = json.loads(Path(args.dataset).read_text())
    jobs = build_render_jobs(
        dataset, args.glb_dir, args.output_dir, args.obj_class,
        args.max_objs_per_class, args.num_gpus, args.blender_path,
        args.resolution, args.views,
    )
    results = render_pool(jobs, args.num_gpus * args.jobs_per_gpu,
                          args.timeout)
    return 0 if all(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
