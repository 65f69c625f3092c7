"""Scene generators, one module each, found by the ``scene`` name of a
traffic file: ``generate(traffic, seed, device) -> Scene``."""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..geometry import Cams, Sim


class Frames(NamedTuple):
    """One RGB-D sequence as a user's scanner stores it."""
    gray: torch.Tensor          # [N,H,W] 0..255
    disparity: torch.Tensor     # [N,H,W] float32, 0 = no depth
    cams: Cams


class Scene(NamedTuple):
    """A job's inputs and what the benchmark knows to be true of them.
    ``truth_*`` is the surface in the frame of the last sequence, the frame
    SRT.txt maps every sequence into; ``gt[k]`` maps sequence k there."""
    sequences: List[Frames]
    truth_vertices: np.ndarray
    truth_faces: np.ndarray
    gt: List[Sim]

    @property
    def frames(self) -> int:
        return sum(f.disparity.shape[0] for f in self.sequences)
