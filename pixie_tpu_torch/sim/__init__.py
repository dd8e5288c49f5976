"""MLS-MPM solver in PyTorch (port of pixie_tpu.sim)."""
