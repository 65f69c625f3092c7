"""Stage checkpoint manifest.

The port's own copy of ``multiviewstitch_tpu/io/manifest.py`` (numpy and
the standard library).

The reference's pipeline is implicitly checkpointed through durable files
(DATA/CHECK/_depth*.raw, Result/SRT.txt, Rec/*.npts, Result/Model.obj — see
SURVEY §5.4; Result/SRT.txt is written at Processor.cpp:855-871 and re-read
by Render at Processor.cpp:1145-1165), including a fragile MoveFileEx
file-swap dance (Processor.cpp:919-931). Here checkpointing is explicit: a
JSON manifest records each stage's outputs with content hashes, so stages
re-run only when inputs changed and there are no file swaps.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, Optional

import numpy as np


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:16]


def hash_arrays(**arrays) -> str:
    """Content hash of a dict of numpy arrays (order-independent by key)."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


class StageManifest:
    """Tracks stage outputs + input hashes under a working directory."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.path = os.path.join(workdir, "manifest.json")
        os.makedirs(workdir, exist_ok=True)
        self._data: Dict = {"stages": {}}
        if os.path.exists(self.path):
            try:
                with open(self.path, "r") as f:
                    self._data = json.load(f)
            except (json.JSONDecodeError, OSError):
                pass

    def stage_dir(self, stage: str) -> str:
        d = os.path.join(self.workdir, stage)
        os.makedirs(d, exist_ok=True)
        return d

    def is_done(self, stage: str, input_hash: Optional[str] = None) -> bool:
        rec = self._data["stages"].get(stage)
        if rec is None:
            return False
        if input_hash is not None and rec.get("input_hash") != input_hash:
            return False
        # verify recorded outputs still exist and match
        for fname, fhash in rec.get("outputs", {}).items():
            fp = os.path.join(self.workdir, fname)
            if not os.path.exists(fp) or _hash_file(fp) != fhash:
                return False
        return True

    def mark_done(self, stage: str, outputs, input_hash: Optional[str] = None,
                  metrics: Optional[Dict] = None):
        rec = {
            "time": time.time(),
            "input_hash": input_hash,
            "outputs": {os.path.relpath(p, self.workdir): _hash_file(p)
                        for p in outputs},
        }
        if metrics:
            rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        self._data["stages"][stage] = rec
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=1)
        os.replace(tmp, self.path)

    def metrics(self, stage: str) -> Dict:
        return self._data["stages"].get(stage, {}).get("metrics", {})

    def save_arrays(self, stage: str, name: str, **arrays) -> str:
        """Save arrays as an .npz artifact inside the stage dir."""
        p = os.path.join(self.stage_dir(stage), name + ".npz")
        np.savez_compressed(p, **arrays)
        return p

    def load_arrays(self, stage: str, name: str):
        p = os.path.join(self.stage_dir(stage), name + ".npz")
        return dict(np.load(p))
