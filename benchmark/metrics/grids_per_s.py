from benchmark.readers import rate as read  # noqa: F401
