"""3D U-Nets (nn.Module) and checkpoint conversion from the JAX package."""
