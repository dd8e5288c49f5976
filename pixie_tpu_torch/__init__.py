"""pixie_tpu_torch — the PIXIE inference slice in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A second implementation beside ``pixie_tpu`` (the JAX reference).  Module
names mirror the JAX package so each counterpart is easy to find:

  * ``pixie_tpu_torch.sim``     — MLS-MPM solver (types, svd3, constitutive
                                  models, boundary conditions, material field,
                                  rollout driver)
  * ``pixie_tpu_torch.ops``     — P2G / G2P transfers: CUDA kernels on CUDA
                                  tensors, plain PyTorch on CPU tensors
  * ``pixie_tpu_torch.models``  — the 3D U-Nets as ``nn.Module``s with the
                                  reference ``epoch_*.pth`` state-dict keys
  * ``pixie_tpu_torch.train``   — combined U-Net inference
  * ``pixie_tpu_torch.voxel``   — prediction -> material PLY mapping
  * ``pixie_tpu_torch.utils``   — PLY/npy I/O, normalization, artifact paths
  * ``pixie_tpu_torch.pipeline``— the voxel grid -> U-Nets -> material PLY ->
                                  MPM rollout stages

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
