"""numpy -> torch converters for the state the align path carries.

The port has no learned weights: its state is cameras, similarities,
sequences, match candidates, BA problems (flat and point-grouped), ARAP
block problems and, in mode 2, meshes with part labels. Callers holding
arrays from elsewhere (for example the JAX package's objects, after
``np.asarray``) hand them over as numpy, so the port never sees a foreign
array type.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.cameras import CameraBatch
from .core.transforms import Similarity
from .pipeline.align_seq import PairCandidate, Sequence
from .pipeline.deform_render import Mesh
from .solvers.ba import BAProblem, BAState


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


def candidate_from_numpy(frame_i, frame_j, uv1, uv2, p1, p2, mask, residual,
                         num_matches) -> PairCandidate:
    """A frame pair's surviving matches (the JAX PairCandidate's fields)
    as the port's PairCandidate, whose arrays stay numpy."""
    return PairCandidate(int(frame_i), int(frame_j),
                         np.array(uv1, np.int32), np.array(uv2, np.int32),
                         np.array(p1, np.float32), np.array(p2, np.float32),
                         np.array(mask, bool), float(residual),
                         int(num_matches))


def ba_problem_from_numpy(K, cam_idx, pt_idx, uv, mask, pt_obs, pt_obs_mask,
                          fixed_cams, cam_of, uv_g, *, device) -> BAProblem:
    """The JAX BAProblem's fields -> BAProblem on ``device`` (float32
    values, int64 indices, bool masks)."""
    def idx(a):
        return torch.as_tensor(np.array(a, np.int64), device=device)

    def flag(a):
        return torch.as_tensor(np.array(a, bool), device=device)
    return BAProblem(_f32(K, device), idx(cam_idx), idx(pt_idx),
                     _f32(uv, device), flag(mask), idx(pt_obs),
                     flag(pt_obs_mask), flag(fixed_cams), idx(cam_of),
                     _f32(uv_g, device))


def ba_state_from_numpy(rvec, tvec, points, *, device) -> BAState:
    """rvec [C,3], tvec [C,3], points [P,3] -> BAState on ``device``."""
    return BAState(_f32(rvec, device), _f32(tvec, device),
                   _f32(points, device))


def ba_blocks_from_numpy(K, cam_of, uv, mask, fixed_cams, *,
                         device) -> "BAPointBlocks":
    """The JAX BAPointBlocks' fields -> the port's BAPointBlocks on
    ``device``."""
    from .parallel.ba_dist import BAPointBlocks
    return BAPointBlocks(_f32(K, device),
                         torch.as_tensor(np.array(cam_of, np.int64),
                                         device=device),
                         _f32(uv, device),
                         torch.as_tensor(np.array(mask, bool), device=device),
                         torch.as_tensor(np.array(fixed_cams, bool),
                                         device=device))


def arap_blocks_from_numpy(rest, targets, constrained, edge_codes, weights,
                           pub, n_vertices: int) -> "ARAPBlockProblem":
    """The JAX ARAPBlockProblem's fields -> the port's ARAPBlockProblem
    (host tensors: each rank moves its own block)."""
    from .parallel.arap_blocks import ARAPBlockProblem
    return ARAPBlockProblem(
        _f32(rest, "cpu"), _f32(targets, "cpu"),
        torch.as_tensor(np.array(constrained, bool)),
        torch.as_tensor(np.array(edge_codes, np.int64)), _f32(weights, "cpu"),
        torch.as_tensor(np.array(pub, np.int64)), int(n_vertices))
