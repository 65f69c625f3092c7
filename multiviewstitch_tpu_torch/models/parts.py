"""Body-part labels: template part lists + exact 1-NN label transfer.

PyTorch counterpart of ``multiviewstitch_tpu/models/parts.py``
(PartRecognition/PartRecognition.{h,cpp}): the 16-part enum
(PartRecognition.h:13-30), the ``Name=i;j;k;...`` part-file parser and
writer (LoadParts, PartRecognition.cpp:7-48) and PartRecog's per-point
1-NN (PartRecognition.cpp:50-77, a FLANN kd-tree there), here a chunked
exact search on the device. The enum, names, colours and file formats are
the port's own copy of the JAX module's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# part ids follow PartRecognition.h:13-30 exactly
HEAD, NECK = 0, 1
LEFT_UPPER_ARM, LEFT_LOWER_ARM, LEFT_HAND = 2, 3, 4
RIGHT_UPPER_ARM, RIGHT_LOWER_ARM, RIGHT_HAND = 5, 6, 7
LEFT_THIGH, LEFT_SHANK, LEFT_FOOT = 8, 9, 10
RIGHT_THIGH, RIGHT_SHANK, RIGHT_FOOT = 11, 12, 13
TRUNCUS, HIP = 14, 15

PART_NAMES: Dict[str, int] = {
    "Head": HEAD, "Neck": NECK,
    "LeftUpperArm": LEFT_UPPER_ARM, "LeftLowerArm": LEFT_LOWER_ARM,
    "LeftHand": LEFT_HAND,
    "RightUpperArm": RIGHT_UPPER_ARM, "RightLowerArm": RIGHT_LOWER_ARM,
    "RightHand": RIGHT_HAND,
    "LeftThigh": LEFT_THIGH, "LeftShank": LEFT_SHANK, "LeftFoot": LEFT_FOOT,
    "RightThigh": RIGHT_THIGH, "RightShank": RIGHT_SHANK,
    "RightFoot": RIGHT_FOOT,
    "Truncus": TRUNCUS, "Hip": HIP,
}

NUM_PARTS = 16

# 16 distinct display colors for part visualization (debug OBJ export,
# PartRecognition.cpp:79-107 analogue)
PART_COLORS = np.asarray([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [170, 110, 40],
    [128, 0, 0], [128, 128, 0], [0, 0, 128], [128, 128, 128],
], np.float32) / 255.0


def load_parts(path: str, num_vertices: int) -> np.ndarray:
    """Parse the reference's part file: lines ``Name=i;j;k;...`` assigning
    template vertex indices to parts (LoadParts, PartRecognition.cpp:7-48).
    Unlisted vertices default to part 0 (HEAD), as in the reference."""
    labels = np.zeros(num_vertices, np.int32)
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            name, _, rest = line.partition("=")
            pid = PART_NAMES.get(name.strip())
            if pid is None:
                continue
            for tok in rest.split(";"):
                tok = tok.strip()
                if tok:
                    labels[int(tok)] = pid
    return labels


def save_parts(path: str, labels: np.ndarray):
    """Write labels back in the reference format (one line per part)."""
    inv = {v: k for k, v in PART_NAMES.items()}
    with open(path, "w") as f:
        for pid in range(NUM_PARTS):
            idx = np.nonzero(labels == pid)[0]
            if len(idx):
                f.write(f"{inv[pid]}=" + ";".join(map(str, idx)) + "\n")


def nearest_neighbor_indices(query, ref, chunk: int = 8192):
    """Exact 1-NN indices [M] (int64, on the device) of query [M,3] into
    ref [N,3], float32 distances from direct differences in chunks of
    ``chunk`` queries: no matmul form, so no TF32 and no cancellation in
    |q|^2 - 2 q.r + |r|^2 to flip close decisions."""
    q = query.to(torch.float32)
    r = ref.to(torch.float32)
    out = [torch.cdist(c, r, compute_mode="donot_use_mm_for_euclid_dist")
           .argmin(1) for c in q.split(chunk)]
    return (torch.cat(out) if out else
            torch.zeros(0, dtype=torch.int64, device=query.device))


def part_recog(template_points, template_labels, scan_points,
               chunk: int = 8192):
    """Transfer template part labels [V] to scan points [M,3] by exact 1-NN
    (PartRecog, PartRecognition.cpp:50-77). Tensors in, labels [M] out."""
    idx = nearest_neighbor_indices(scan_points, template_points, chunk)
    return template_labels[idx]


def visualize_parts(path: str, points: np.ndarray, labels: np.ndarray):
    """Colored-point OBJ export (Visualization, PartRecognition.cpp:79-107)."""
    from ..io.meshio import write_obj
    colors = PART_COLORS[np.asarray(labels) % NUM_PARTS]
    write_obj(path, points, None, None, colors=colors)


def load_shoulder_joints(path: str) -> Dict[str, List[int]]:
    """Parse Template/ShoulderJoint: per-side annotated joint vertex lists
    (LoadShoulderJoints, PartRecognition.cpp:110-138), ``Left=...`` /
    ``Right=...`` index lists."""
    out: Dict[str, List[int]] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            name, _, rest = line.partition("=")
            out[name.strip()] = [int(t) for t in rest.split(";") if t.strip()]
    return out
