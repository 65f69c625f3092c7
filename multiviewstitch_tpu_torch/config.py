"""Typed, immutable pipeline configuration.

The port's own copy of ``multiviewstitch_tpu/config.py`` (standard library
only), so the port imports nothing of the JAX package; the field names,
types and defaults are held equal to the JAX package's by
``tests/test_torch_config.py``.

Replaces the reference's global-mutable-static config
(``Parameter/ParamParser.{h,cpp}``: ~30 static knobs consumed from every
translation unit, e.g. ``ParamParser.cpp:5-43`` defaults). Here the config is
a frozen dataclass threaded explicitly through the pipeline; the loader also
accepts the legacy whitespace-keyword file format (``ParamParser.cpp:54-90``,
full key set in ``config.txt:1-38``) and the ``#``-commented image-dir list
file (``ParamParser.cpp:93-106``) for parity testing against the reference.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Tuple

# Legacy key -> (field name, type).  Mirrors the reference's dispatch table
# (ParamParser.cpp:58-90) one-to-one, so any reference config.txt loads.
_LEGACY_KEYS = {
    "WriteMesh": ("write_mesh", bool),
    "Segment": ("segment", bool),
    "AllSeqProj": ("all_seq_proj", bool),
    "ViewCount": ("view_count", int),
    "MinMatchCount": ("min_match_count", int),
    "IterNum": ("iter_num", int),
    "SampleIterval": ("sample_interval", int),  # sic: reference spells it this way
    "SSDWin": ("ssd_win", int),
    "Axis": ("axis", int),
    "RotAngle": ("rot_angle", float),
    "PixelError": ("pixel_err", float),
    "AdtPxlErrRatio": ("adapt_pixel_err_ratio", float),
    "SSDError": ("ssd_err", float),
    "ReprojError": ("reproj_err", int),
    "DistMax": ("distmax", float),
    "RatioMax": ("ratiomax", float),
    "HLMarginRatio": ("hl_margin_ratio", float),
    "VLMarginRatio": ("vl_margin_ratio", float),
    "HRMarginRatio": ("hr_margin_ratio", float),
    "VRMarginRatio": ("vr_margin_ratio", float),
    "MinDsp": ("min_dsp", float),
    "MaxDsp": ("max_dsp", float),
    "ImgPathList": ("img_path_list", str),
    "PtSampRds": ("sample_radius", int),
    "NbrFrmNum": ("nbr_frm_num", int),
    "NbrFrmStep": ("nbr_frm_step", int),
    "MaxDspErr": ("dsp_err", float),
    "MinConf": ("conf_min", float),
    "EdgeSzThres": ("edge_sz_thres", float),
    "PsnDptMax": ("psn_dpt_max", int),
    "PsnDptMin": ("psn_dpt_min", int),
    "DistThreshold": ("dist_thres", float),
    "SmoothThreshold": ("smooth_thres", float),
}


@dataclass(frozen=True)
class StitchConfig:
    """All pipeline knobs. Defaults match the reference's compiled-in
    defaults (ParamParser.cpp:5-43), NOT its shipped config.txt (they differ
    in the reference too)."""

    # -- sequence alignment ------------------------------------------------
    write_mesh: bool = False
    segment: bool = False
    all_seq_proj: bool = False
    view_count: int = 1            # synthesized virtual views per frame
    min_match_count: int = 5       # min surviving matches to accept a pair
    iter_num: int = 100            # RANSAC iterations
    sample_interval: int = 24      # min pixel spacing for match NMS
    ssd_win: int = 7               # photometric SSD window half-size context
    reproj_err: int = 4            # px threshold for depth-consistency test
    axis: int = 0                  # rotation axis for virtual views (0=x,1=y,2=z)
    rot_angle: float = 10.0        # degrees between virtual views
    ssd_err: float = 16.0          # max SSD to keep a match
    pixel_err: float = 55.0        # px reprojection threshold for outlier pruning
    adapt_pixel_err_ratio: float = 0.6  # threshold shrink factor per round
    distmax: float = 0.7           # descriptor distance threshold
    ratiomax: float = 0.8          # Lowe ratio threshold
    hl_margin_ratio: float = 0.1   # image margin masks for feature detection
    hr_margin_ratio: float = 0.25
    vl_margin_ratio: float = 0.33
    vr_margin_ratio: float = 0.25
    min_dsp: float = 0.0001        # valid disparity range
    max_dsp: float = 0.5
    img_path_list: str = ""
    image_dirs: Tuple[str, ...] = ()

    # -- reconstruction ----------------------------------------------------
    sample_radius: int = 2         # point-sampling stride in pixels
    nbr_frm_num: int = 5           # neighbor frames for multi-frame agreement
    nbr_frm_step: int = 1
    dsp_err: float = 0.01          # max disparity disagreement between frames
    conf_min: float = 0.6          # min agreement confidence to keep a point
    edge_sz_thres: float = 4.0     # max triangle edge (in px-depth units)
    psn_dpt_max: int = 10          # reconstruction grid depth (octree-depth analogue)
    psn_dpt_min: int = 7

    # -- template alignment ------------------------------------------------
    dist_thres: float = 0.7
    smooth_thres: float = 0.1

    # -- new framework knobs (no reference analogue) -----------------------
    max_keypoints: int = 1024      # static per-view keypoint capacity
    max_matches: int = 2048        # static per-pair match capacity
    ransac_rounds: int = 3         # outlier-pruning rounds (Processor.cpp:198)
    debug_artifacts: bool = False  # dump per-stage debug images/meshes

    def replace(self, **kw) -> "StitchConfig":
        return dataclasses.replace(self, **kw)


def _parse_scalar(ty, tok: str):
    if ty is bool:
        return bool(int(tok))
    return ty(tok)


def load_legacy_config(path: str, load_image_dirs: bool = True) -> StitchConfig:
    """Parse the reference's config file format.

    Token-stream keyword parser equivalent to ParamParser::setParamFromFile
    (ParamParser.cpp:45-107): whitespace-separated ``Key value`` tokens,
    ``#``-prefixed tokens start a comment token (the reference skips only the
    token itself; we skip to end-of-line which accepts the same shipped files).
    """
    updates = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            i = 0
            while i + 1 < len(toks):
                key, val = toks[i], toks[i + 1]
                if key in _LEGACY_KEYS:
                    field, ty = _LEGACY_KEYS[key]
                    updates[field] = _parse_scalar(ty, val)
                    i += 2
                else:
                    i += 1

    cfg = StitchConfig(**updates)
    if load_image_dirs and cfg.img_path_list:
        lst = cfg.img_path_list
        if not os.path.isabs(lst):
            lst = os.path.join(os.path.dirname(os.path.abspath(path)), lst)
        if os.path.exists(lst):
            cfg = cfg.replace(image_dirs=tuple(load_image_dir_list(lst)))
    return cfg


def load_image_dir_list(path: str):
    """Parse the indirected image-dir list file (ParamParser.cpp:93-106):
    one dir per whitespace token, ``#``-prefixed tokens are comments."""
    dirs = []
    with open(path, "r") as f:
        for line in f:
            for tok in line.split():
                if tok.startswith("#"):
                    break
                dirs.append(tok)
    return dirs
