"""Structured metrics logging (JSONL) + in-memory history, as
``repro.runtime.metrics``."""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np


class MetricsLogger:
    """Append-only JSONL metrics log.

    It owns its file handle: the
    :class:`~repro_torch.experiments.runner.Runner` closes it on
    completion and on exceptions.  ``clock`` injects the timestamp source
    for the ``t`` field — the Runner passes its simulated clock, so logs
    from identical resumed runs diff clean.
    """

    def __init__(self, path: Optional[str] = None, echo: bool = False,
                 clock: Optional[Callable[[], float]] = None):
        self.path = path
        self.echo = echo
        self.clock = clock if clock is not None else time.time
        self.history = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, **kv):
        rec = {"t": self.clock(), **{k: _to_py(v) for k, v in kv.items()}}
        try:
            line = json.dumps(rec)
        except TypeError:
            # a non-JSON value slipped through _to_py: degrade that value
            # to repr() and mark the record instead of crashing mid-round
            rec = {k: v if _dumpable(v) else repr(v)
                   for k, v in rec.items()}
            rec["_repr"] = True
            line = json.dumps(rec)
        self.history.append(rec)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            msg = " ".join(f"{k}={v:.5g}" if isinstance(v, float)
                           else f"{k}={v}"
                           for k, v in rec.items() if k != "t")
            print(msg, flush=True)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def _dumpable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


def _to_py(v):
    """One-element tensors and numpy scalars become Python numbers."""
    try:
        if hasattr(v, "numel") and v.numel() == 1:
            return v.item()
        if hasattr(v, "item") and getattr(v, "size", 2) == 1:
            return v.item()
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
    except Exception:
        pass
    return v
