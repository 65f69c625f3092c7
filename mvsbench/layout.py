"""The reference's on-disk layout (docs/DATA.md), written by the benchmark:
``config.txt``, ``imgPathList.txt`` and per sequence ``seq<k>/`` with
``cameras.act`` (the .act calibration format), ``%05d.jpg`` frames and
``DATA/_depth%d.raw`` float32 disparity rasters."""

from __future__ import annotations

import os

import numpy as np

from .scenes import Scene


def write_act(path: str, cams):
    """The .act calibration of one camera batch (one intrinsic block, then
    a 4x4 [R|t] per frame). numpy's float32 text round-trips exactly."""
    K = cams.K.cpu().numpy()
    R = cams.R.cpu().numpy()
    t = cams.t.cpu().numpy()
    n = R.shape[0]
    lines = ["# mvsbench calibration", "<intrinsic parameter>",
             f"{K[0, 0, 0]} {K[0, 1, 1]} {K[0, 0, 2]} {K[0, 1, 2]}",
             "start:0", "step:1", f"end:{n - 1}", "<Camera Track>"]
    for i in range(n):
        lines += ["----", f"frame{i}"]
        lines += [f"{R[i, r, 0]} {R[i, r, 1]} {R[i, r, 2]} {t[i, r]}"
                  for r in range(3)]
        lines += ["0 0 0 1", "----"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def config_text(settings: dict) -> str:
    """A legacy config.txt of ``Key value`` pairs."""
    out = ["# mvsbench configuration", "ImgPathList ./imgPathList.txt"]
    for key, val in settings.items():
        if isinstance(val, bool):
            val = int(val)
        out.append(f"{key} {val}")
    return "\n".join(out) + "\n"


def write_layout(root: str, scene: Scene, settings: dict) -> str:
    """Write ``scene`` under ``root``; returns the config.txt path."""
    from PIL import Image
    dirs = []
    for k, seq in enumerate(scene.sequences):
        d = os.path.join(root, f"seq{k}")
        os.makedirs(os.path.join(d, "DATA"), exist_ok=True)
        write_act(os.path.join(d, "cameras.act"), seq.cams)
        disp = seq.disparity.cpu().numpy().astype(np.float32)
        gray = np.clip(seq.gray.cpu().numpy(), 0, 255).astype(np.uint8)
        for i in range(disp.shape[0]):
            disp[i].tofile(os.path.join(d, "DATA", f"_depth{i}.raw"))
            Image.fromarray(gray[i]).save(os.path.join(d, f"{i:05d}.jpg"),
                                          quality=95)
        dirs.append(f"./seq{k}/")
    with open(os.path.join(root, "imgPathList.txt"), "w") as f:
        f.write("\n".join(dirs) + "\n")
    path = os.path.join(root, "config.txt")
    with open(path, "w") as f:
        f.write(config_text(settings))
    return path
