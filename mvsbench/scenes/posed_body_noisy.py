"""A body scanner with a real sensor: the posed body of ``posed_body`` seen
by two full rings of portrait RGB-D cameras, the second ring's world moved
by one similarity, with the sensor noise of ``bumpy_sphere`` on the
images and the depth.

The body, its pose and the rings are ``posed_body``'s; the focal length is
the traffic's ``focal`` (a sensor's intrinsics, which a smaller frame
scales with). Traffic keys: sequences (2: the first ring and the moved
one), frames, width, height, focal, cam_radius, arm_deg, leg_deg,
ring_offset_deg (the second ring is turned by it against the first),
scale, yaw_deg, translation, noise (the sensor-noise level; its draws come
from the seed), depth_noise (whether the noise reaches the depth as well
as the images). The seed turns both rings by one angle drawn below one
frame step (as ``posed_body`` draws it) and draws the noise; every seed
gives the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fixtures import (apply_sensor_noise, draw_sensor_noise, move_scene,
                        render_mesh, ring_cameras, textured_views)
from ..geometry import Sim, yaw_sim
from . import Frames, Scene
from .posed_body import make_template, pose_template


def require_robust_ba():
    """Raise where the port's ``--refine ba`` solves on every observation.

    The chain of a noisy ring carries wrong matches (and tracks one wrong
    match merged) that reproject tens to hundreds of pixels off; in the
    least squares they hold the LM still or pull it off a good chain, up
    to 9 degrees on some seeds. The port leaves them out before the solve
    in ``pipeline.ba_refine.drop_outliers``; a port without it cannot run
    this scene's cell."""
    from multiviewstitch_tpu_torch.pipeline import ba_refine
    if not callable(getattr(ba_refine, "drop_outliers", None)):
        raise RuntimeError(
            "posed_body_noisy: the port's --refine ba has no outlier drop "
            "(multiviewstitch_tpu_torch.pipeline.ba_refine.drop_outliers); "
            "the noisy body rings need it: no run")


def generate(traffic: dict, seed: int, device) -> Scene:
    require_robust_ba()
    if traffic["sequences"] != 2:
        raise ValueError("posed_body_noisy: two rings (sequences 2), got "
                         f"{traffic['sequences']}")
    tv, tf, tl = make_template()
    posed = pose_template(tv, tl, arm_angle_deg=traffic["arm_deg"],
                          leg_spread_deg=traffic["leg_deg"]).astype(
                              np.float32)
    center = posed.mean(0)
    n = traffic["frames"]
    phase = float(np.random.default_rng(int(seed)).uniform(0.0, 360.0 / n))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    gt = yaw_sim(traffic["scale"], traffic["yaw_deg"],
                 traffic["translation"])
    seqs = []
    for k, T in enumerate((None, gt)):
        cams = ring_cameras(
            n, radius=traffic["cam_radius"], width=traffic["width"],
            height=traffic["height"], focal=float(traffic["focal"]),
            look_at=tuple(center.tolist()), cam_height=float(center[1]),
            phase_deg=phase + k * traffic["ring_offset_deg"], device=device)
        v, c = (posed, cams) if T is None else move_scene(posed, cams, T)
        disp = render_mesh(v, tf, c)
        gray = textured_views(c, disp, None if T is None else T.inverse())
        if traffic["noise"] > 0:
            gray, disp = apply_sensor_noise(
                gray, disp, traffic["noise"],
                draw_sensor_noise(disp.shape, gen), traffic["depth_noise"])
        seqs.append(Frames(gray, disp, c))
    return Scene(seqs, v, tf, [gt, Sim(1.0, np.eye(3), np.zeros(3))])
