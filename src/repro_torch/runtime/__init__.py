"""Runtime machinery around the training loops: metrics log, round
journal, checkpoints (as ``repro.runtime``)."""
