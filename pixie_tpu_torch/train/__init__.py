"""Combined U-Net inference."""
