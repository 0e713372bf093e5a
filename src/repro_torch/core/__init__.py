from repro_torch.core import (
    aggregation,
    auxiliary,
    evaluate,
    losses,
    splitting,
    steps,
)
from repro_torch.core.uit import AmpereTrainer

__all__ = [
    "aggregation", "auxiliary", "evaluate", "losses", "splitting", "steps",
    "AmpereTrainer",
]
