"""The voxelizer, CLIP part segmentation and its heatmaps, and the
prediction -> material point cloud mapping."""
