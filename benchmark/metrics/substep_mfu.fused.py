from benchmark.readers import substep_mfu as read  # noqa: F401
