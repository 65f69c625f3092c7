"""A hand-held object scan: a bumpy sphere seen by ``sequences`` camera
arcs, sequence k moved by the k-th power of one similarity.

Traffic keys: sequences, frames, width, height, focal, arc_deg,
arc_offset_deg (sequence k's arc is turned by k times it), turn_deg (the
seed turns every arc by one angle drawn below it: the object lies at any
orientation), cam_radius, radius, bumps, n_lat, n_lon, scale, yaw_deg,
translation, noise (the sensor-noise level; its draws come from the
seed), depth_noise (whether the noise reaches the depth as well as the
images). Every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fixtures import (apply_sensor_noise, draw_sensor_noise, move_scene,
                        render_mesh, ring_cameras, textured_views,
                        uv_sphere)
from ..geometry import Sim, yaw_sim
from . import Frames, Scene


def _power(step: Sim, k: int) -> Sim:
    out = Sim(1.0, np.eye(3), np.zeros(3))
    for _ in range(k):
        out = Sim(step.s * out.s, step.R @ out.R, step.s * step.R @ out.t
                  + step.t)
    return out


def generate(traffic: dict, seed: int, device) -> Scene:
    verts, faces = uv_sphere(traffic["n_lat"], traffic["n_lon"],
                             radius=traffic["radius"],
                             bumps=traffic["bumps"])
    step = yaw_sim(traffic["scale"], traffic["yaw_deg"],
                   traffic["translation"])
    n_seq = traffic["sequences"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    turn = float(torch.rand((), generator=gen, device=device,
                            dtype=torch.float64)) * traffic["turn_deg"]
    seqs, moved = [], []
    for k in range(n_seq):
        T = _power(step, k)
        cams = ring_cameras(
            traffic["frames"], radius=traffic["cam_radius"],
            width=traffic["width"], height=traffic["height"],
            focal=traffic["focal"], arc_deg=traffic["arc_deg"],
            arc_center_deg=turn + k * traffic["arc_offset_deg"],
            device=device)
        v_k, cams_k = move_scene(verts, cams, T)
        disp = render_mesh(v_k, faces, cams_k)
        gray = textured_views(cams_k, disp, T.inverse())
        if traffic["noise"] > 0:
            gray, disp = apply_sensor_noise(
                gray, disp, traffic["noise"],
                draw_sensor_noise(disp.shape, gen), traffic["depth_noise"])
        seqs.append(Frames(gray, disp, cams_k))
        moved.append(T)
    last = moved[-1]
    # sequence k -> the last sequence's frame: T_last o T_k^-1
    gt = [Sim(last.s / T.s, last.R @ T.R.T,
              last.t - (last.s / T.s) * (last.R @ T.R.T) @ T.t)
          for T in moved]
    return Scene(seqs, v_k, faces, gt)
