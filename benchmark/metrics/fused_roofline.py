from benchmark.readers import fused_roofline as read  # noqa: F401
