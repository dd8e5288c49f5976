"""pixie_tpu_torch — the PIXIE inference path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A second implementation beside ``pixie_tpu`` (the JAX reference).  Module
names mirror the JAX package so each counterpart is easy to find:

  * ``pixie_tpu_torch.sim``     — MLS-MPM solver (types, svd3, constitutive
                                  models, boundary conditions, material field,
                                  rollout driver, per-frame splat render)
  * ``pixie_tpu_torch.recon``   — 3D gaussians, projection and the tile
                                  rasterizer, fields, CLIP's towers and
                                  tokenizer
  * ``pixie_tpu_torch.ops``     — P2G / G2P transfers and the tile blend: CUDA
                                  kernels on CUDA tensors, plain PyTorch on
                                  CPU tensors
  * ``pixie_tpu_torch.models``  — the 3D U-Nets as ``nn.Module``s with the
                                  reference ``epoch_*.pth`` state-dict keys
  * ``pixie_tpu_torch.train``   — combined U-Net inference
  * ``pixie_tpu_torch.voxel``   — the voxelizer, CLIP part segmentation,
                                  prediction -> material PLY mapping
  * ``pixie_tpu_torch.vlm_labeler`` — the VLM labeling chain
  * ``pixie_tpu_torch.utils``   — PLY/npy I/O, normalization, artifact paths,
                                  point-cloud images, mesh paint, commands
  * ``pixie_tpu_torch.pipeline``— capture -> field / 3DGS -> voxel grid ->
                                  U-Nets or the VLM chain -> material PLY ->
                                  MPM rollout (-> rendered frames) stages
  * ``pixie_tpu_torch.render``  — the output renders (``python -m``)
  * ``pixie_tpu_torch.blender`` — the bpy scripts Blender runs for the
                                  capture and the Blender render modes
  * ``pixie_tpu_torch/conf/``   — the YAML config tree ``config.compose`` reads

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
