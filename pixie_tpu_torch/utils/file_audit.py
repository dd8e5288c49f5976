"""An audit hook that records every file of the JAX package a process opens
or runs.

The port keeps its own copy of whatever it needs from ``pixie_tpu/``; a
check of ``sys.modules`` cannot see a file read or run by path, so
``watch_jax_package`` installs a ``sys.addaudithook`` hook that records

  * every ``open`` whose resolved path lies under ``<root>/pixie_tpu/``;
  * every ``subprocess.Popen``, ``os.exec`` and ``os.posix_spawn`` whose
    working directory, or whose program or an argument (or a word of a
    shell command line) holding a ``/``, names such a path, resolved
    against the child's working directory.

An audit hook lasts as long as its process: install it in a process made for
the check (a subprocess in the tests, ``chip_smoke.py``'s own run).
"""

from __future__ import annotations

import os
import sys
import threading
from pathlib import Path

_SPAWNS = ("subprocess.Popen", "os.exec", "os.posix_spawn")


def watch_jax_package(root: str | Path | None = None) -> list[str]:
    """Install the hook for the files under ``root/pixie_tpu/`` (default: the
    checkout this package lies in) and return the list it appends to: the
    resolved path of each open, and ``"<event>: <path>"`` for each spawn."""
    root = Path(__file__).resolve().parents[2] if root is None else Path(root)
    prefix = os.path.join(os.path.realpath(root / "pixie_tpu"), "")
    found: list[str] = []
    local = threading.local()  # the hook's own path lookups are not audited again

    def under(arg, cwd: str) -> str | None:
        # an exception here would fail the audited call: skip what is no path
        # (a descriptor, None, a name with a NUL byte)
        try:
            path = os.path.realpath(os.path.join(cwd, os.fsdecode(arg)))
        except (TypeError, ValueError):
            return None
        return path if os.path.join(path, "").startswith(prefix) else None

    def hook(event: str, args: tuple) -> None:
        if (event != "open" and event not in _SPAWNS) or getattr(local, "busy", False):
            return
        local.busy = True
        try:
            if event == "open":
                hit = under(args[0], os.getcwd())
                if hit:
                    found.append(hit)
                return
            exe, argv = args[0], args[1]
            cwd = os.getcwd()
            if event == "subprocess.Popen" and args[2] is not None:
                cwd = os.path.join(cwd, os.fsdecode(args[2]))
                hit = under(cwd, "")
                if hit:
                    found.append(f"{event}: cwd {hit}")
            words = []
            for arg in (exe, *(argv or ())):
                if isinstance(arg, (str, bytes, os.PathLike)):
                    arg = os.fsdecode(arg)
                    words += {arg, *arg.split()}
            for word in words:
                hit = "/" in word and under(word, cwd)
                if hit:
                    found.append(f"{event}: {hit}")
        finally:
            local.busy = False

    sys.addaudithook(hook)
    return found
