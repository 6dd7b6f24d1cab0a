"""LiDAR decoders and the optional feature extraction."""
