from benchmark.readers import substep_roofline as read  # noqa: F401
