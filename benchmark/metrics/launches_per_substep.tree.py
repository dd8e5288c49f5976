from benchmark.readers import launches_per_substep as read  # noqa: F401
