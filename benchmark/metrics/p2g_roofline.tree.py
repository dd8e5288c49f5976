from benchmark.readers import p2g_roofline as read  # noqa: F401
