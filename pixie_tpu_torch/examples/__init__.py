"""Runnable examples of the port (port of the repo's examples/): each runs
on the card unless ``--cpu`` is given.

    python -m pixie_tpu_torch.examples.jelly_drop
    python -m pixie_tpu_torch.examples.pixie_e2e
    python -m pixie_tpu_torch.examples.pipeline_cli_e2e
    python -m pixie_tpu_torch.examples.walkthrough
    python -m pixie_tpu_torch.examples.real_scene_walkthrough
"""


def default_out(name: str) -> str:
    """An example's default output directory, under the temporary directory."""
    import tempfile
    from pathlib import Path

    return str(Path(tempfile.gettempdir()) / name)
