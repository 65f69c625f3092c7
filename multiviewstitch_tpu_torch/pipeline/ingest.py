"""Real-data ingestion: the reference's on-disk sequence layout -> Sequences.

PyTorch counterpart of ``multiviewstitch_tpu/pipeline/ingest.py``. Layout
per image dir (from the reference's loaders; ``docs/DATA.md``):
  <dir>/*.act                calibration (LoadCameras, Processor.cpp:20-27
                             via ScanNSortDirectory *.act)
  <dir>/DATA/_depth<i>.raw   float32 disparity rasters (Processor.cpp:37)
  <dir>/<%05d>.jpg           RGB frames (Image3D.cpp:21)
Image dirs come from the config's imgPathList (ParamParser.cpp:93-106).
Files are read and decoded on the host (worker threads in
``load_sequences``; the raw depth through the native threaded reader,
``io/native_loader.load_raw_batch``, whose ``read_counts`` say which reader
ran); the tensors move to the device on the caller's thread.
"""

from __future__ import annotations

import glob
import os
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import StitchConfig
from ..core.cameras import CameraBatch, load_act, save_act
from ..io.native_loader import load_raw_batch
from ..io.rawdepth import save_depth_raw
from .align_seq import Sequence


class _HostSequence(NamedTuple):
    gray: np.ndarray        # [N,H,W] float32
    disparity: np.ndarray   # [N,H,W] float32
    cams: CameraBatch       # on the CPU


def _load_gray_image(path: str, width: int, height: int) -> np.ndarray:
    """Load an image as grayscale float (0..255), resized if needed —
    the reference's cv::imread + RGB2GRAY path (Common/Utils.h:221-262)."""
    from PIL import Image
    img = Image.open(path).convert("L")
    if img.size != (width, height):
        img = img.resize((width, height))
    return np.asarray(img, np.float32)


def _read_sequence_dir(imgdir: str, use_check: bool) -> _HostSequence:
    acts = sorted(glob.glob(os.path.join(imgdir, "*.act")))
    if not acts:
        raise FileNotFoundError(f"no .act calibration in {imgdir}")
    cams = load_act(acts[0], device="cpu")
    n = len(cams)
    w, h = cams.width, cams.height

    sub = os.path.join("DATA", "CHECK") if use_check else "DATA"
    raw_paths = [os.path.join(imgdir, sub, f"_depth{i}.raw")
                 for i in range(n)]
    missing = [p for p in raw_paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"missing depth rasters, e.g. {missing[0]}")
    disp = load_raw_batch(raw_paths, w, h)

    grays = []
    for i in range(n):
        candidates = [os.path.join(imgdir, f"{i:05d}.jpg"),
                      os.path.join(imgdir, f"{i:05d}.png"),
                      os.path.join(imgdir, f"{i}.jpg")]
        path = next((c for c in candidates if os.path.exists(c)), None)
        if path is None:
            # depth-only sequences are allowed: use normalized disparity as
            # the photometric channel (features still found on depth edges)
            g = disp[i] / max(float(disp[i].max()), 1e-9) * 255.0
        else:
            g = _load_gray_image(path, w, h)
        grays.append(g)
    gray = np.stack(grays) if n else np.zeros((0, h, w), np.float32)
    return _HostSequence(gray, disp, cams)


def _to_device(hs: _HostSequence, device) -> Sequence:
    return Sequence(torch.as_tensor(hs.gray, device=device),
                    torch.as_tensor(hs.disparity, device=device),
                    hs.cams.to(device))


def load_sequence_dir(imgdir: str, cfg: StitchConfig,
                      use_check: bool = False, *, device) -> Sequence:
    """Load one sequence directory onto ``device``. use_check reads
    DATA/CHECK depths (the consistency-filtered set the reference swaps in,
    Processor.cpp:919-931)."""
    return _to_device(_read_sequence_dir(imgdir, use_check), device)


def load_sequences(cfg: StitchConfig, base_dir: str = ".",
                   use_check: bool = False, *, device) -> List[Sequence]:
    """Load all sequences listed in the config's image-dir list onto
    ``device``: directory i+1 is read and decoded on a worker thread
    (``prefetch_map``) while directory i moves to the device here."""
    from .executor import prefetch_map
    dirs = [d if os.path.isabs(d) else os.path.join(base_dir, d)
            for d in cfg.image_dirs]
    return [_to_device(hs, device) for hs in prefetch_map(
        lambda full: _read_sequence_dir(full, use_check), dirs)]


def save_sequence_dir(imgdir: str, seq: Sequence, start: int = 0):
    """Write a Sequence back in the reference layout (the same files as the
    JAX package's save_sequence_dir: cameras.act, DATA/_depth<i>.raw and
    <%05d>.jpg at quality 95)."""
    from PIL import Image

    os.makedirs(os.path.join(imgdir, "DATA"), exist_ok=True)
    save_act(os.path.join(imgdir, "cameras.act"), seq.cams, start=start)
    disp = seq.disparity.cpu().numpy()
    gray = seq.gray.cpu().numpy()
    for i in range(disp.shape[0]):
        save_depth_raw(os.path.join(imgdir, "DATA", f"_depth{i}.raw"),
                       disp[i])
        img = np.clip(gray[i], 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(imgdir, f"{i:05d}.jpg"),
                                  quality=95)
