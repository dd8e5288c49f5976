"""Video compilation of rendered frames (port of
pixie_tpu/utils/viz.py:compile_video, host only, same behaviour)."""

from __future__ import annotations

import logging
from pathlib import Path


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
