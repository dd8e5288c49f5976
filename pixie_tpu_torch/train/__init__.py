"""U-Net training and inference: the dataset, normalization ranges, the
trainer, combined inference and its reports."""
