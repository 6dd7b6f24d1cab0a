"""Voxel-hash map (port of fast_lio_tpu.map)."""
