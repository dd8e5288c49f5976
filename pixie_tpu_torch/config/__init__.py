"""Config composition over the shared YAML tree (copy of pixie_tpu.config)."""

from pixie_tpu_torch.config.core import Config, compose, load_yaml_tree

__all__ = ["Config", "compose", "load_yaml_tree"]
