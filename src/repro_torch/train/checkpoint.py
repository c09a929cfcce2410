"""Checkpoints of a port train state in the reference's layout.

The port of ``repro.train.checkpoint`` (one process: no shardings).
``save`` writes every leaf of the reference's train state as
``<dir>/step_<k>/<flat-name>.npy`` plus a ``manifest.json`` (step, each
leaf's name, shape and dtype, and ``extra``: the data iterator's
state), first into ``step_<k>.tmp`` and then renamed, so a partial write
is never visible.  The leaves are the reference's
(``repro_torch.models.convert.flat_train_state``): stacked layers,
weights ``[in, out]``, the optimizer state under the same names, so each
package restores the other's checkpoints.  bfloat16 goes to disk as its
raw bytes (a ``uint8`` view, whose shape the manifest records, under the
logical dtype ``bfloat16``) and comes back through
``torch.Tensor.view(torch.bfloat16)``: numpy has no bfloat16 here.

``AsyncSaver`` copies the state to the host at once and writes it on a
thread, overlapping the next train steps; ``wait()`` joins it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.models.convert import flat_train_state, load_flat_train_state


def snapshot(state: dict) -> list:
    """The state's leaves on the host: ``(name, array, logical dtype)``,
    bfloat16 as its ``uint8`` bytes."""
    out = []
    for name, t in flat_train_state(state):
        t = t.detach().cpu().contiguous()
        logical = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.uint8).numpy()
        else:
            arr = t.numpy()
        out.append((name, arr, logical))
    return out


def _write(host: list, directory: str, step: int,
           extra: Optional[dict]) -> str:
    d = os.path.join(directory, f"step_{step:08d}")
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, arr, logical in host:
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append({"name": name, "shape": list(arr.shape),
                                   "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)        # atomic publish: partial writes never visible
    return d


def save(state: dict, directory: str, step: int,
         extra: Optional[dict] = None) -> str:
    return _write(snapshot(state), directory, step, extra)


class AsyncSaver:
    """Overlap checkpoint serialization with the next train steps."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, state: dict, directory: str, step: int,
             extra: Optional[dict] = None) -> None:
        self.wait()
        # snapshot to host synchronously (cheap vs disk IO), write async
        host = snapshot(state)

        def work():
            try:
                self.last_path = _write(host, directory, step, extra)
            except Exception as e:           # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", f))]
    return max(steps) if steps else None


def restore(directory: str, step: int, target_state: dict) -> tuple:
    """Load checkpoint ``step`` into ``target_state`` (a port train state
    of the same config and optimizer), in place.  Returns (state,
    extra).  Raises on a missing leaf or a shape that is not the
    target's."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {l["name"]: l for l in manifest["leaves"]}

    def get(name):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.load(os.path.join(d, name + ".npy"))
        logical = by_name[name]["dtype"]
        if str(arr.dtype) == logical:
            return torch.from_numpy(arr) if arr.ndim else arr
        if logical != "bfloat16" or arr.dtype != np.uint8:
            raise TypeError(f"{name}: {arr.dtype} on disk, {logical} in "
                            "the manifest")
        return torch.from_numpy(arr).view(torch.bfloat16)

    load_flat_train_state(target_state, get)
    return target_state, manifest.get("extra", {})
