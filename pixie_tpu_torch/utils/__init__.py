"""Host utilities carried over from pixie_tpu.utils: PLY/npy I/O,
material normalization and artifact paths (numpy only)."""
