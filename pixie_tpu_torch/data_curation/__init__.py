"""Dataset curation's host parts (port of pixie_tpu/data_curation/curation.py
and manual_filter.py).  ``render_pool.py`` drives Blender and stays in the
JAX package."""
