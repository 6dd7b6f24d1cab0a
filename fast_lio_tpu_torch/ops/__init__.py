"""Per-scan point operations: downsample, plane fit, measurement model."""
