"""Host utilities carried over from pixie_tpu.utils: PLY/npy I/O,
material normalization, artifact paths, point-cloud images, mesh paint,
commands and observability."""
