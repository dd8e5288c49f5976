"""Data parallelism over torch.distributed (U-Net training)."""
