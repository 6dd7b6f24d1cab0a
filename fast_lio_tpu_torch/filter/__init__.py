"""Filter engine: process model and iterated EKF (port of fast_lio_tpu.filter)."""
