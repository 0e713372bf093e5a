"""Checkpoint / restart, as ``repro.runtime.checkpoint``.

* Atomic on-disk layout — written to ``<dir>/tmp.<step>.<pid>`` then
  ``os.replace``-d into ``<dir>/step_<n>``; a crashed writer never
  corrupts the latest checkpoint, and stale ``tmp.*`` dirs are swept when
  a :class:`Checkpointer` opens the directory.
* Async save — ``save_async`` copies the tree to the host before it
  returns and serializes it on a thread; ``wait()`` joins before the next
  save, a restore, or exit.
* Phase-aware — the metadata carries the phase and its progress, so a
  restart resumes each phase from its own newest snapshot
  (``steps_matching``), and ``keep`` counts per phase.

Format: ``step_<n>/arrays.npz`` with path-flattened arrays plus
``meta.json`` (the caller's metadata, ``step`` and ``arrays_crc``, the
CRC32 of the arrays file, checked on restore).  Tensors leave through
``.detach().cpu().numpy()``; numpy has no bfloat16, so a bf16 tensor is
stored as its raw bits (uint16) and never as float32.  ``meta.json``
records each tensor's dtype (``torch_dtypes``) and each Python scalar's
type (``py_types``), so :meth:`Checkpointer.restore` gives back tensors of
the saved dtype on the caller's device and Python numbers where the tree
held them.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.transport.framing import crc32

_PY_TYPES = {"int": int, "float": float, "bool": bool}


class CheckpointCorruptError(Exception):
    """A checkpoint exists on disk but cannot be trusted (CRC mismatch,
    torn arrays file, unreadable metadata)."""


def _to_host(t, key: str, torch_dtypes: dict, py_types: dict):
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", copy=True)   # a snapshot, never a view
        torch_dtypes[key] = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(t, (bool, int, float)):
        py_types[key] = type(t).__name__
    return np.asarray(t)


def _flatten(tree):
    """(flat arrays, torch_dtypes, py_types) keyed by '/'-joined paths;
    lists/tuples record their length and kind, ``None`` a marker."""
    flat, torch_dtypes, py_types = {}, {}, {}

    def rec(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(t, (list, tuple)):
            flat[f"{prefix}/__len__" if prefix else "__len__"] = np.asarray(
                [len(t), int(isinstance(t, tuple))])
            for i, v in enumerate(t):
                rec(f"{prefix}/{i}" if prefix else str(i), v)
        elif t is None:
            flat[f"{prefix}/__none__" if prefix else "__none__"] = \
                np.asarray(0)
        else:
            flat[prefix] = _to_host(t, prefix, torch_dtypes, py_types)
    rec("", tree)
    return flat, torch_dtypes, py_types


def _unflatten(flat):
    """Rebuild the nested dict/list structure from path keys."""
    root: Any = {}

    def ins(d, parts, val):
        k = parts[0]
        if len(parts) == 1:
            d[k] = val
        else:
            d = d.setdefault(k, {})
            ins(d, parts[1:], val)

    for key in sorted(flat):
        ins(root, key.split("/"), flat[key])

    def fix(node):
        if isinstance(node, dict):
            if "__none__" in node and len(node) == 1:
                return None
            if "__len__" in node:
                n, is_tuple = (int(node["__len__"][0]),
                               bool(node["__len__"][1]))
                seq = [fix(node[str(i)]) for i in range(n)]
                return tuple(seq) if is_tuple else seq
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(root)


def _from_host(flat: dict, torch_dtypes: dict, py_types: dict, device):
    out = {}
    for k, a in flat.items():
        if k in torch_dtypes:
            dtype = getattr(torch, torch_dtypes[k])
            if dtype == torch.bfloat16:
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            out[k] = t.to(device)
        elif k in py_types:
            out[k] = _PY_TYPES[py_types[k]](a.item())
        else:
            out[k] = a
    return out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, fault_plan=None):
        self.dir = directory
        self.keep = keep
        # chaos runs: a FaultPlan whose torn_write(f"ckpt/{step}") fires
        # truncates the arrays file after its CRC is recorded, so restore
        # detects the tear and falls back to an older snapshot
        self.fault_plan = fault_plan
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        # a writer killed between makedirs(tmp) and os.replace leaves a
        # tmp.<step>.<pid> dir behind; only step_<n> dirs are restored,
        # so sweep them when the coordinator starts
        for d in os.listdir(directory):
            if d.startswith("tmp."):
                shutil.rmtree(os.path.join(directory, d),
                              ignore_errors=True)

    # ------------------------------------------------------------------
    def _step_dirs(self):
        if not os.path.isdir(self.dir):
            return []
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, d)))
        return sorted(out)

    def _meta_of(self, d: str) -> dict:
        try:
            with open(os.path.join(d, "meta.json")) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def steps_matching(self, predicate=None) -> list:
        """All steps newest-first whose metadata matches ``predicate``
        (all of them when None) — the fallback chain for a restore that
        finds its newest snapshot corrupt."""
        return [step for step, d in reversed(self._step_dirs())
                if predicate is None or predicate(self._meta_of(d))]

    # ------------------------------------------------------------------
    def save(self, step: int, tree, metadata: Optional[dict] = None):
        self.wait()
        self._write(step, _flatten(tree), metadata or {})

    def save_async(self, step: int, tree, metadata: Optional[dict] = None):
        self.wait()
        host = _flatten(tree)   # on the host before returning
        self._thread = threading.Thread(
            target=self._write, args=(step, host, metadata or {}),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host, metadata: dict):
        flat, torch_dtypes, py_types = host
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        arrays = os.path.join(tmp, "arrays.npz")
        np.savez(arrays, **flat)
        # the CRC is recorded over the intact file, before any injected
        # tear, so a torn publish is detected at restore
        with open(arrays, "rb") as f:
            arrays_crc = crc32(f.read())
        torn = (self.fault_plan.torn_write(f"ckpt/{step}")
                if self.fault_plan is not None else None)
        if torn is not None:
            size = os.path.getsize(arrays)
            with open(arrays, "r+b") as f:
                f.truncate(max(1, int(size * torn)))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "arrays_crc": arrays_crc,
                       "torch_dtypes": torch_dtypes, "py_types": py_types,
                       **metadata}, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        """Keep the newest ``keep`` checkpoints per phase (meta "phase",
        absent = one shared group), so a later phase's saves never evict
        an earlier phase's resume point."""
        if not self.keep:
            return
        by_phase: dict = {}
        for _, d in self._step_dirs():
            by_phase.setdefault(self._meta_of(d).get("phase"), []).append(d)
        for dirs in by_phase.values():
            for d in dirs[:-self.keep]:
                shutil.rmtree(d, ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None, device="cpu"):
        """Returns (tree, metadata) or (None, None) when nothing exists;
        tensors come back on ``device``.

        With an explicit ``step``, a corrupt snapshot raises
        :class:`CheckpointCorruptError`.  With ``step=None`` the newest
        valid snapshot wins: corrupt ones are skipped in favor of the next
        older, and only when every snapshot is corrupt does the error
        propagate.
        """
        self.wait()
        if step is not None:
            return self._restore_one(step, device)
        last_err: Optional[Exception] = None
        for s in self.steps_matching():
            try:
                return self._restore_one(s, device)
            except CheckpointCorruptError as err:
                last_err = err
        if last_err is not None:
            raise last_err
        return None, None

    def _restore_one(self, step: int, device):
        d = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as err:
            raise CheckpointCorruptError(
                f"step {step}: unreadable metadata: {err}") from err
        try:
            with open(os.path.join(d, "arrays.npz"), "rb") as f:
                raw = f.read()
        except OSError as err:
            raise CheckpointCorruptError(
                f"step {step}: unreadable arrays file: {err}") from err
        declared = meta.pop("arrays_crc", None)
        if declared is not None and crc32(raw) != declared:
            raise CheckpointCorruptError(
                f"step {step}: arrays.npz checksum mismatch (torn write or "
                "bit flip); restore(step=None) falls back to an older "
                "snapshot")
        try:
            with np.load(io.BytesIO(raw)) as z:
                flat = {k: z[k] for k in z.files}
        except Exception as err:
            raise CheckpointCorruptError(
                f"step {step}: undecodable arrays.npz: {err}") from err
        flat = _from_host(flat, meta.pop("torch_dtypes", {}),
                          meta.pop("py_types", {}), device)
        return _unflatten(flat), meta
