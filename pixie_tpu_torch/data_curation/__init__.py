"""Dataset curation (port of pixie_tpu/data_curation/): the host parts,
``curation.py`` and ``manual_filter.py``, and ``render_pool.py``, the
process pool that renders a curated dataset through the port's
``blender/generate_blendernerf_data.py``."""

__all__ = ["curation", "manual_filter", "render_pool"]
