"""Fault-tolerant checkpoint manager, in the JAX package's format.

The port's own copy of ``repro/checkpoint/manager.py`` (which imports
JAX): each step is a directory ``step_XXXXXXXX`` holding ``arrays.npz``
and ``manifest.json`` (shape, logical dtype, stored dtype and a sha256
prefix per tensor), written as ``step_XXXXXXXX.tmp`` and renamed only
after the manifest is fsynced, so a killed save never leaves an unreadable
"latest". Saves may run on a background thread (one in flight at a time);
``restore_latest`` skips corrupt or partial steps; the newest ``keep``
steps are kept. Keys are the "/"-joined paths of a nested dict.

bfloat16 goes through npz as its uint16 bit pattern with the logical dtype
in the manifest (the JAX ``_encode``/``_decode``), so a directory written
by either package reads in the other with every bit kept. Trees may hold
torch tensors or numpy arrays; ``restore_latest`` returns CPU tensors.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zipfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import flatten_dict, unflatten_dict


def _checksum(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _encode(v: Any) -> Tuple[np.ndarray, str]:
    """npz-safe array and its logical dtype name: bfloat16 (a torch tensor,
    or an ``ml_dtypes`` numpy array) is stored as a uint16 view."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(v)
    if a.dtype.kind in "fiub?":
        return a, str(a.dtype)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8), str(a.dtype)


def _decode(a: np.ndarray, logical: str) -> torch.Tensor:
    if str(a.dtype) == logical:
        return torch.from_numpy(np.array(a, copy=True))
    if logical == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    raise ValueError(f"stored dtype {a.dtype} of logical dtype {logical!r} is not supported")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Dict[str, Any], wait: bool = False) -> None:
        """Snapshot ``tree`` (nested dicts of tensors / arrays) at ``step``.
        The host copy is taken here; the write may run on a thread."""
        self.wait()  # one in-flight save at a time
        host: Dict[str, np.ndarray] = {}
        logical: Dict[str, str] = {}
        for k, v in flatten_dict(tree).items():
            host[k], logical[k] = _encode(v)

        def _write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
                final = os.path.join(self.dir, f"step_{step:08d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                manifest: Dict[str, Any] = {"step": step, "tensors": {}}
                np.savez(os.path.join(tmp, "arrays.npz"), **host)
                for k, v in host.items():
                    manifest["tensors"][k] = {
                        "shape": list(v.shape),
                        "dtype": logical[k],
                        "stored_dtype": str(v.dtype),
                        "sha": _checksum(v),
                    }
                mpath = os.path.join(tmp, "manifest.json")
                with open(mpath, "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # atomic commit
                self._gc()
            except BaseException as e:  # re-raised by the next wait()
                self._last_error = e

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
            if wait:
                self.wait()
        else:
            _write()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise RuntimeError(f"checkpoint save failed: {e!r}") from e

    def _gc(self):
        steps = self.available_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def available_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def _load_step(self, step: int) -> Optional[Dict[str, torch.Tensor]]:
        path = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as data:
                out = {}
                for k, meta in manifest["tensors"].items():
                    a = data[k]
                    if _checksum(a) != meta["sha"]:
                        raise IOError(f"checksum mismatch for {k}")
                    out[k] = _decode(a, meta["dtype"])
            return out
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            # a corrupt or partial checkpoint (unreadable or truncated file,
            # checksum mismatch, bad json, a tensor missing from the npz, a
            # torn zip): the caller falls back to an older step. Anything
            # else is a bug and propagates.
            return None

    def restore_latest(self, place_fn: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                       ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(step, tree of CPU tensors) of the newest readable checkpoint, or
        None when there is none. ``place_fn(key, tensor)`` may replace each
        leaf (its flat key) by this rank's part of it, as JAX's
        ``sharding_fn`` re-lays a checkpoint onto the current mesh."""
        for step in reversed(self.available_steps()):
            flat = self._load_step(step)
            if flat is not None:
                if place_fn is not None:
                    flat = {k: place_fn(k, v) for k, v in flat.items()}
                return step, unflatten_dict(flat)
        return None
