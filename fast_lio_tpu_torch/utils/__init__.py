"""Host utilities: timing logs, stage timers, checkpoints."""
