"""Minimal hydra-compatible config composition.

The reference composes hydra groups from ``config/config.yaml`` with
``${...}`` interpolation and CLI dotlist overrides
(reference: pipeline.py:438 ``@hydra.main``, config/config.yaml,
config/training/default.yaml:39-40 for nested interpolation).  This module
reimplements the subset pixie uses without the hydra dependency:

  * a config directory with a top-level ``config.yaml`` containing a
    ``defaults`` list of ``group: option`` entries, each resolving to
    ``<group>/<option>.yaml`` loaded under key ``group``;
  * ``${a.b.c}`` interpolation, including nested interpolations such as
    ``${training.features.${training.feature_type}.feature_channels}``;
  * dotlist overrides ``a.b=value`` (with ``+a.b=value`` to add new keys).

Copied from pixie_tpu/config/core.py (yaml only) so that the port imports
nothing of the JAX package.  The YAML tree itself, ``pixie_tpu/conf/``, is
the config contract: ``compose`` reads it by path, as data.
"""

from __future__ import annotations

import copy
import json
import re
from pathlib import Path
from typing import Any

import yaml

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")
# the YAML tree shared with the JAX package (data, not an import)
CONF_DIR = Path(__file__).resolve().parents[2] / "pixie_tpu" / "conf"


class Config(dict):
    """A dict with attribute access and dotted-path get/set."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    # -- dotted paths ----------------------------------------------------
    def select(self, path: str, default: Any = ...) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                if default is ...:
                    raise KeyError(path)
                return default
        return node

    def update_path(self, path: str, value: Any, allow_new: bool = True) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                if not allow_new and part not in node:
                    raise KeyError(f"unknown config key: {path}")
                node[part] = Config()
            node = node[part]
        if not allow_new and parts[-1] not in node:
            raise KeyError(f"unknown config key: {path} (use +{path}= to add)")
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        def conv(x):
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, list):
                return [conv(v) for v in x]
            return x

        return conv(self)

    def pretty(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _parse_value(text: str) -> Any:
    """Parse an override value like hydra: yaml-typed scalars and json lists."""
    try:
        return yaml.safe_load(text)
    except Exception:
        return text


def _resolve_str(s: str, root: Config, seen: tuple[str, ...]) -> Any:
    """Resolve innermost-first ``${...}`` interpolations in a string."""
    while True:
        m = _INTERP_RE.search(s)
        if m is None:
            return s
        path = m.group(1)
        if path in seen:
            raise ValueError(f"circular interpolation at ${{{path}}}")
        val = root.select(path)
        if isinstance(val, str):
            val = _resolve_str(val, root, seen + (path,))
        if m.start() == 0 and m.end() == len(s):
            return val  # whole-string interpolation keeps the value's type
        s = s[: m.start()] + str(val) + s[m.end():]


def _resolve(node: Any, root: Config, _seen=()) -> Any:
    if isinstance(node, dict):
        for k in list(node.keys()):
            node[k] = _resolve(node[k], root, _seen)
        return node
    if isinstance(node, list):
        return [_resolve(v, root, _seen) for v in node]
    if isinstance(node, str) and "${" in node:
        return _resolve_str(node, root, _seen)
    return node


def _merge(dst: Config, src: dict) -> Config:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = _wrap(copy.deepcopy(v))
    return dst


def load_yaml_tree(path: str | Path) -> Config:
    with open(path) as f:
        return _wrap(yaml.safe_load(f) or {})


def compose(
    config_dir: str | Path | None = None,
    overrides: list[str] | None = None,
    config_name: str = "config",
) -> Config:
    """Compose a config like ``hydra.main`` would.

    ``config_dir`` defaults to the repository's ``pixie_tpu/conf`` tree,
    read by path.
    """
    if config_dir is None:
        config_dir = CONF_DIR
    config_dir = Path(config_dir)

    top = load_yaml_tree(config_dir / f"{config_name}.yaml")
    defaults = top.pop("defaults", [])
    cfg = Config()
    for entry in defaults:
        if entry == "_self_":
            _merge(cfg, top)
            continue
        if isinstance(entry, str):
            group, option = entry, "default"
        else:
            (group, option), = entry.items()
        group_cfg = load_yaml_tree(config_dir / group / f"{option}.yaml")
        _merge(cfg, Config({group: group_cfg}))
    if "_self_" not in defaults:
        _merge(cfg, top)

    for ov in overrides or []:
        key, sep, value = ov.lstrip("+").partition("=")
        if not sep:
            raise ValueError(f"malformed override {ov!r} (expected key=value)")
        cfg.update_path(key, _wrap(_parse_value(value)))

    _resolve(cfg, cfg)
    return cfg


def save_config(cfg: Config, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(cfg.pretty())


def load_sim_config(json_file: str | Path) -> dict:
    """Load a PhysGaussian per-scene JSON config (decode_param.py input)."""
    with open(json_file) as f:
        return json.load(f)
