"""Fault-tolerant checkpointing (the reference's
``repro.checkpoint.checkpoint``; its files, keys and messages).

* Atomic: write to ``<dir>/tmp.<step>.npz`` then ``os.replace`` — a crash
  mid-save never corrupts the latest checkpoint.
* Async: the device→host copy happens synchronously, the disk write runs on
  a background thread so the train loop keeps stepping.
* Device-agnostic / elastic: arrays are stored whole under their tree
  paths (``params/blocks/attn/wq``, ``opt/step``: the reference's
  ``tree_leaves_with_path`` keys joined by '/'), bf16 leaves as f32;
  ``restore`` re-narrows each leaf to the template's dtype and puts it on
  the template's device, or on ``device`` — resuming on another device
  than the saver's is just a different target.  A checkpoint written by
  either package restores in the other.
* Journaled: ``latest_step`` scans the directory, so restart-after-preemption
  needs no external coordinator state.
"""
from __future__ import annotations

import json
import os
import threading
import time
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.index.io import IndexCorruptionError
from repro_torch.training.tree import leaves_with_path, path_key, unflatten_like

#: the errors a truncated or corrupt npz (or one of its members) raises
_CORRUPT = (zipfile.BadZipFile, zlib.error, ValueError, OSError, EOFError)


def _open_npz(path: Path, step: int):
    """np.load with truncation/corruption rewritten into a clear error
    naming the checkpoint file and step."""
    try:
        return np.load(path)
    except FileNotFoundError:
        raise
    except _CORRUPT as e:
        raise IndexCorruptionError(
            f"checkpoint step {step} ({path}) is truncated or corrupt: "
            f"{e}") from e


def _read_member(z, key: str, path: Path, step: int) -> np.ndarray:
    """Read one npz member; a bad per-member CRC only surfaces at read
    time, so wrap that too."""
    try:
        return z[key]
    except _CORRUPT as e:
        raise IndexCorruptionError(
            f"checkpoint step {step} ({path}): member {key!r} is "
            f"truncated or corrupt: {e}") from e


def _host(leaf) -> np.ndarray:
    """A leaf as a host array of its own; bf16 widened to f32 (exact;
    restore re-narrows).  Always a copy: the train step updates the state
    in place while the writer thread may still be reading it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        elif leaf.device.type == "cpu":               # .cpu() made no copy
            t = t.clone()
        return t.numpy()
    a = np.array(leaf)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        a = a.astype(np.float32)
    return a


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path_key(p): _host(leaf) for p, leaf in leaves_with_path(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}.npz"

    def all_steps(self):
        return sorted(int(p.stem.split("_")[1]) for p in self.dir.glob("step_*.npz"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = False,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Device→host copy now; disk write async unless blocking=True."""
        self.wait()                                   # one in-flight save max
        flat = _flatten(state)                        # host copies
        meta = json.dumps(dict(step=step, time=time.time(), **(extra or {})))

        def write():
            try:
                tmp = self.dir / f"tmp.{step}.npz"
                np.savez(tmp, __meta__=np.frombuffer(meta.encode(), np.uint8),
                         **flat)
                os.replace(tmp, self._path(step))
                self._gc()
            except BaseException as e:               # surfaced on next wait()
                self._last_error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            self._path(s).unlink(missing_ok=True)

    # ------------------------------------------------------------------
    def restore(self, state_like, step: Optional[int] = None,
                device=None) -> Any:
        """Rebuild the tree of ``state_like`` (same structure).  A tensor
        leaf comes back as a tensor of its dtype on ``device`` (default: the
        leaf's own device) — the elastic path, a restore onto another device
        than the saver's; an array leaf (or any other) comes back as a host
        array of its dtype."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        items = list(leaves_with_path(state_like))
        out = []
        # context-manage the npz: np.load keeps the zip member file open
        # until closed, so a bare handle leaks one fd per restore
        with _open_npz(self._path(step), step) as z:
            for path, leaf in items:
                key = path_key(path)
                if key not in z.files:
                    raise KeyError(
                        f"checkpoint step {step} ({self._path(step)}) has no "
                        f"entry for tree path {key!r}; the restore template "
                        f"does not match the saved state (saved keys: "
                        f"{sorted(k for k in z.files if k != '__meta__')})")
                a = _read_member(z, key, self._path(step), step)
                if isinstance(leaf, torch.Tensor):
                    t = torch.from_numpy(np.asarray(a, order="C")).to(
                        device=device if device is not None else leaf.device)
                    out.append(t.to(leaf.dtype))
                    continue
                want = getattr(leaf, "dtype", None)
                if want is not None and str(a.dtype) != str(want):
                    a = a.astype(want)
                out.append(a)
        return unflatten_like(state_like, out)

    def meta(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        with _open_npz(self._path(step), step) as z:
            if "__meta__" not in z.files:
                raise KeyError(f"checkpoint step {step} ({self._path(step)}) "
                               f"has no __meta__ entry")
            return json.loads(bytes(
                _read_member(z, "__meta__", self._path(step), step)).decode())

    def restore_flat(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Every saved array keyed by tree path — the template-free restore
        used by :meth:`restore_index`.  A truncated or checksum-mangled
        member raises ``IndexCorruptionError`` naming the file and step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with _open_npz(self._path(step), step) as z:
            return {k: _read_member(z, k, self._path(step), step)
                    for k in z.files if k != "__meta__"}

    # ------------------------------------------------------------------
    # Index checkpointing: an RNSGIndex (with its installed quantized
    # corpora) or a StreamingRFANN rides through the same atomic-npz step
    # machinery as model state; the array tree and its manifest come from
    # ``repro_torch.index.io``.
    def save_index(self, step: int, index, *, blocking: bool = True,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        from repro_torch.index.io import index_state
        flat, manifest = index_state(index)
        self.save(step, flat, blocking=blocking,
                  extra=dict(extra or {}, index=manifest))

    def restore_index(self, step: Optional[int] = None, device=None):
        """The saved index onto ``device`` (default the card)."""
        from repro_torch.index.io import index_from_state
        meta = self.meta(step)
        if "index" not in meta:
            raise KeyError(f"checkpoint step "
                           f"{step if step is not None else self.latest_step()}"
                           f" was not written by save_index (no index "
                           f"manifest in __meta__)")
        return index_from_state(self.restore_flat(step), meta["index"],
                                device=device)
