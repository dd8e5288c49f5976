"""3D Gaussian Splatting: the parameter model and the forward splat
rasterizer (port of pixie_tpu.recon; training is not ported yet)."""
