"""Prediction -> material point cloud mapping (host, numpy)."""
