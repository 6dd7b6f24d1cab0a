"""Manifold math (SO(3), S^2): port of fast_lio_tpu.math."""
