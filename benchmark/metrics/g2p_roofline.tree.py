from benchmark.readers import g2p_roofline as read  # noqa: F401
