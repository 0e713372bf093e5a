"""Runtime machinery around the training loops: metrics log, round
journal, heartbeats, checkpoints and the elastic cohort (as
``repro.runtime``)."""
