"""Result/SRT.txt pose-chain checkpoint format.

PyTorch counterpart of ``multiviewstitch_tpu/io/srt.py`` (the reference
writes per-sequence (scale, R, t) blocks, Processor.cpp:855-871: a scale
line, three rotation rows, a translation row). ``save_srt`` runs as the
span ``io.write_srt`` and counts its bytes (``io.bytes.<file name>``).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..core.transforms import Similarity
from ..utils.profiling import count, span


def save_srt(path: str, transforms: List[Similarity]):
    name = os.path.basename(path)
    with span("io.write_srt", file=name):
        with open(path, "w") as f:
            for T in transforms:
                R = T.R.detach().cpu().double().numpy()
                t = T.t.detach().cpu().double().numpy()
                f.write(f"{float(T.s)}\n")
                for r in range(3):
                    f.write(f"{R[r, 0]} {R[r, 1]} {R[r, 2]}\n")
                f.write(f"{t[0]} {t[1]} {t[2]}\n")
        count("io.bytes." + name, os.path.getsize(path))


def load_srt(path: str) -> List[Similarity]:
    with open(path) as f:
        vals = [float(tok) for tok in f.read().split()]
    out = []
    for i in range(0, len(vals) - 12, 13):
        out.append(Similarity(
            torch.tensor(vals[i], dtype=torch.float32),
            torch.as_tensor(np.asarray(vals[i + 1:i + 10],
                                       np.float32).reshape(3, 3)),
            torch.as_tensor(np.asarray(vals[i + 10:i + 13], np.float32))))
    return out
