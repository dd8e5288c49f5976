"""Point-cloud scatter images, cuboid overlays and video compilation
(port of pixie_tpu/utils/viz.py, host numpy, copied unchanged)."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

# tab10-like palette for material/part labels
PALETTE = np.array(
    [
        [31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
        [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
        [188, 189, 34], [23, 190, 207],
    ],
    np.uint8,
)


def render_pointcloud_image(
    points: np.ndarray,
    labels: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    res: int = 512,
    axis: int = 1,
    bg: float = 1.0,
    point_size: int = 2,
) -> np.ndarray:
    """Orthographic scatter of a point cloud to an (res,res,3) float image.

    Projects along ``axis``; z-orders by the projected-out coordinate.
    ``point_size`` is the square splat edge in pixels.
    """
    points = np.asarray(points, np.float32)
    if len(points) == 0:
        return np.full((res, res, 3), bg, np.float32)
    keep_axes = [a for a in range(3) if a != axis]
    uv = points[:, keep_axes]
    depth = points[:, axis]
    lo = uv.min(axis=0)
    hi = uv.max(axis=0)
    span = np.maximum((hi - lo).max(), 1e-6)
    px = ((uv - lo) / span * (res - 1)).astype(np.int64)

    if colors is None:
        if labels is not None:
            colors = PALETTE[np.asarray(labels).astype(np.int64) % len(PALETTE)] / 255.0
        else:
            colors = np.full((len(points), 3), 0.2, np.float32)

    order = np.argsort(depth)  # back to front
    img = np.full((res, res, 3), bg, np.float32)
    # y axis flipped for image coordinates; square splat of point_size pixels
    for dy in range(point_size):
        for dx in range(point_size):
            yy = np.clip(res - 1 - px[order, 1] + dy, 0, res - 1)
            xx = np.clip(px[order, 0] + dx, 0, res - 1)
            img[yy, xx] = colors[order]
    return img


def draw_cuboid_outline(img: np.ndarray, center, size, bounds_lo, span,
                        res: int, color=(1.0, 0.0, 0.0), axis: int = 1):
    """Overlay an axis-aligned cuboid outline on a scatter image."""
    keep = [a for a in range(3) if a != axis]
    c = np.asarray(center, np.float32)[keep]
    s = np.asarray(size, np.float32)[keep]
    lo = ((c - s - bounds_lo) / span * (res - 1)).astype(int)
    hi = ((c + s - bounds_lo) / span * (res - 1)).astype(int)
    lo = np.clip(lo, 0, res - 1)
    hi = np.clip(hi, 0, res - 1)
    y0, y1 = res - 1 - hi[1], res - 1 - lo[1]
    img[y0:y1 + 1, [lo[0], hi[0]]] = color
    img[[y0, y1], lo[0]:hi[0] + 1] = color
    return img


def compile_video(frame_dir: str | Path, output_path: str | Path, fps: int = 30):
    """PNG frames -> video; falls back to an animated GIF when imageio/ffmpeg
    are unavailable (viz_utils video compile equivalent)."""
    frames = sorted(Path(frame_dir).glob("*.png"))
    if not frames:
        logging.warning("no frames in %s", frame_dir)
        return None
    try:
        import imageio.v3 as iio  # noqa: PLC0415

        imgs = [iio.imread(f) for f in frames]
        iio.imwrite(output_path, imgs, fps=fps)
        return output_path
    except Exception:  # noqa: BLE001  (any imageio/ffmpeg failure: GIF instead)
        from PIL import Image  # noqa: PLC0415

        gif = Path(output_path).with_suffix(".gif")
        imgs = [Image.open(f) for f in frames]
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        logging.info("imageio unavailable; wrote %s", gif)
        return gif
