from benchmark.readers import device_ms_per_unit as read  # noqa: F401
