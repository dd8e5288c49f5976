from benchmark.readers import unet_mfu as read  # noqa: F401
