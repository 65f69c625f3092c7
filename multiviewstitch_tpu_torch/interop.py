"""numpy -> torch converters for the state the align path carries.

The port has no learned weights: its state is cameras, similarities,
sequences and, in mode 2, meshes with part labels. Callers holding arrays from elsewhere (for example the JAX
package's objects, after ``np.asarray``) hand them over as numpy, so the
port never sees a foreign array type.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.cameras import CameraBatch
from .core.transforms import Similarity
from .pipeline.align_seq import Sequence
from .pipeline.deform_render import Mesh


def _f32(a, device):
    return torch.as_tensor(np.array(a, np.float32), device=device)


def cameras_from_numpy(K, R, t, width: int, height: int,
                       device) -> CameraBatch:
    """K [...,3,3], R [...,3,3], t [...,3] -> CameraBatch on ``device``."""
    return CameraBatch(_f32(K, device), _f32(R, device), _f32(t, device),
                       int(width), int(height))


def similarity_from_numpy(s, R, t, device) -> Similarity:
    """s [...], R [...,3,3], t [...,3] -> Similarity on ``device``."""
    return Similarity(_f32(s, device), _f32(R, device), _f32(t, device))


def sequence_from_numpy(gray, disparity, K, R, t, width: int, height: int,
                        device) -> Sequence:
    """gray/disparity [N,H,W] + per-frame cameras -> Sequence on
    ``device``."""
    return Sequence(_f32(gray, device), _f32(disparity, device),
                    cameras_from_numpy(K, R, t, width, height, device))


def mesh_from_numpy(verts, faces, labels=None, *, device) -> Mesh:
    """verts [V,3], faces [F,3] and optional part labels [V] -> Mesh on
    ``device`` (float32 vertices, int64 faces, int32 labels)."""
    return Mesh(_f32(verts, device),
                torch.as_tensor(np.array(faces, np.int64), device=device),
                None if labels is None else
                torch.as_tensor(np.array(labels, np.int32), device=device))
