"""Subprocess runner with error-pattern scanning + logging setup.

Copied from pixie_tpu/utils/proc.py (host only), unchanged apart from its imports.

Port of pixie/utils.py:21-223: ``set_logger`` (colored console logging) and
``run_cmd`` — runs a child process, streams output, greps it for known error
patterns and aborts the pipeline unless the pattern is whitelisted (the
reference uses this around every Blender/external stage; the rebuilt pipeline
is library-first but the external stages still shell out).
"""

from __future__ import annotations

import logging
import subprocess
import sys

ERROR_PATTERNS = (
    "Traceback (most recent call last)",
    "CUDA out of memory",
    "RuntimeError",
    "AssertionError",
    "Segmentation fault",
    "core dumped",
    "FileNotFoundError",
    "ModuleNotFoundError",
)

# Known-harmless patterns (reference whitelists Blender addon noise,
# pixie/utils.py:108-133)
WHITELIST_PATTERNS = (
    "add-on not loaded",
    "Warning: Add-on",
    "expected a view3d region",
    "Unable to open a display",
)

# Whole-output contextual allowlist: these failure signatures are forgiven
# ONLY when a success indicator also appears (reference
# _is_blender_nerf_error_only / _is_gaussian_splatting_addon_error_only,
# pixie/utils.py:108-133).  Each entry: (noise patterns any-of,
# success indicators any-of).
CONTEXTUAL_ALLOWLIST = (
    # harmless BlenderNeRF camera lookup error
    (("BlenderNeRF Camera",),
     ("Blender quit", "Finished", "Normalized scene exported")),
    # harmless Gaussian Splatting addon unregister error
    (("missing bl_rna attribute from '_RNAMeta' instance",
      "Exception in module unregister():",
      "gaussian_splatting_io"),
     ("Blender quit", "Finished", "Video saved to")),
)


def _is_allowlisted_noise(output_text: str) -> bool:
    """True when the output's error signature matches a contextual allowlist
    entry AND the corresponding success indicator is present."""
    for noise, success in CONTEXTUAL_ALLOWLIST:
        if any(p in output_text for p in noise) and any(
            s in output_text for s in success
        ):
            return True
    return False


class CommandError(RuntimeError):
    pass


def set_logger(level=logging.INFO):
    """Colored console logging (pixie/utils.py:21-66 set_logger)."""
    fmt = "%(asctime)s %(levelname)s %(message)s"
    try:
        import colorlog  # noqa: PLC0415

        handler = colorlog.StreamHandler()
        handler.setFormatter(
            colorlog.ColoredFormatter("%(log_color)s" + fmt)
        )
        logging.basicConfig(level=level, handlers=[handler], force=True)
    except ImportError:
        logging.basicConfig(level=level, format=fmt, force=True)


def run_cmd(cmd, allow_error: bool = False, cwd=None, env=None,
            echo: bool = True) -> str:
    """Run a command, scanning output for error patterns (pixie/utils.py:163-223).

    Returns captured output; raises CommandError on nonzero exit or an
    un-whitelisted error pattern (unless allow_error).
    """
    if isinstance(cmd, str):
        shell = True
        display = cmd
    else:
        shell = False
        display = " ".join(map(str, cmd))
    logging.info("run_cmd: %s", display)

    proc = subprocess.Popen(
        cmd, shell=shell, cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    flagged = None
    for line in proc.stdout:
        lines.append(line)
        if echo:
            sys.stdout.write(line)
        if flagged is None:
            stripped = line.strip()
            if any(p in stripped for p in ERROR_PATTERNS) and not any(
                w in stripped for w in WHITELIST_PATTERNS
            ):
                flagged = stripped
    proc.wait()
    output = "".join(lines)

    if flagged is not None and _is_allowlisted_noise(output):
        logging.info("ignoring allowlisted error noise (%r): command "
                     "completed with a success indicator", flagged)
        flagged = None

    failed = proc.returncode != 0 or flagged is not None
    if failed and not allow_error:
        raise CommandError(
            f"command failed (rc={proc.returncode}"
            + (f", matched error pattern: {flagged!r}" if flagged else "")
            + f"): {display}"
        )
    if failed:
        logging.warning("command failed but allow_error=True: %s", display)
    return output


def save_contextual_config(cfg, out_dir, stage: str):
    """Per-stage config snapshot for provenance
    (save_contextual_config, pixie/utils.py:457-535)."""
    from pathlib import Path  # noqa: PLC0415

    path = Path(out_dir) / f"config_{stage}.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(cfg.pretty())
    return str(path)
