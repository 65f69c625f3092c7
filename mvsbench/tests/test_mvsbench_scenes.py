"""The benchmark's frozen scene fixtures against the port's, at a tiny size
on the CPU: the same meshes, cameras, renders, textures and noise."""

import numpy as np
import pytest
import torch

from multiviewstitch_tpu_torch.core.transforms import Similarity
from multiviewstitch_tpu_torch.models import template_body as port_body
from multiviewstitch_tpu_torch.pipeline import fixtures as port
from mvsbench import fixtures as fx
from mvsbench.geometry import Sim
from mvsbench.scenes import bumpy_sphere, posed_body

CPU = torch.device("cpu")


def test_uv_sphere():
    for bumps in (0.0, 0.15):
        v, f = fx.uv_sphere(12, 18, radius=0.5, bumps=bumps)
        pv, pf = port.uv_sphere(12, 18, radius=0.5, bumps=bumps)
        np.testing.assert_array_equal(v, pv)
        np.testing.assert_array_equal(f, pf)


@pytest.mark.parametrize("kw", [dict(arc_deg=45.0, arc_center_deg=1.5),
                                dict(arc_deg=360.0)])
def test_ring_cameras(kw):
    c = fx.ring_cameras(5, radius=2.0, width=64, height=48, focal=52.5,
                        look_at=(0.1, 0.2, 0.0), cam_height=0.2,
                        device=CPU, **kw)
    p = port.ring_cameras(5, radius=2.0, width=64, length_focal=52.5,
                          img_height=48, look_at=(0.1, 0.2, 0.0),
                          height=0.2, device=CPU, **kw)
    for a, b in ((c.K, p.K), (c.R, p.R), (c.t, p.t)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_moved_render_and_texture_match_the_port():
    R = np.array([[0.9689124, 0.0, 0.24740396], [0.0, 1.0, 0.0],
                  [-0.24740396, 0.0, 0.9689124]], np.float32)
    T = Similarity(torch.tensor(1.3), torch.as_tensor(R),
                   torch.tensor([0.15, -0.1, 0.2]))
    sim = Sim(float(T.s), T.R.double().numpy(), T.t.double().numpy())
    scene = port.make_scene(n_frames=3, width=64, height=48, bumps=0.15,
                            n_lat=16, n_lon=24, arc_deg=45.0,
                            transform=T, device=CPU)
    v, f = fx.uv_sphere(16, 24, radius=0.5, bumps=0.15)
    cams = fx.ring_cameras(3, radius=2.0, width=64, height=48, focal=120.0,
                           arc_deg=45.0, device=CPU)
    mv, mc = fx.move_scene(v, cams, sim)
    np.testing.assert_array_equal(mv, scene.vertices)
    disp = fx.render_mesh(mv, f, mc)
    torch.testing.assert_close(disp, scene.disparity, rtol=0, atol=0)
    gray = fx.textured_views(mc, disp, sim.inverse())
    torch.testing.assert_close(gray, port.textured_views(scene), rtol=0,
                               atol=2e-3)


def test_sensor_noise_matches_the_port_on_its_draws():
    rng = np.random.default_rng(7)
    gray = rng.uniform(0, 255, (2, 12, 16)).astype(np.float32)
    disp = rng.uniform(0.4, 0.7, (2, 12, 16)).astype(np.float32)
    disp[:, :2] = 0.0
    for level in (1.0, 2.0):
        pg, pd = port.sensor_noise(gray, disp, level, seed=3)
        r = np.random.default_rng(3)
        draws = dict(gain=torch.as_tensor(r.uniform(-0.08, 0.08, 2)),
                     offset=torch.as_tensor(r.uniform(-4.0, 4.0, 2)),
                     pixel=torch.as_tensor(r.normal(size=gray.shape)
                                           .astype(np.float32)),
                     depth=torch.as_tensor(r.normal(size=disp.shape)
                                           .astype(np.float32)),
                     drop=torch.as_tensor(r.random(disp.shape)))
        g, d = fx.apply_sensor_noise(torch.as_tensor(gray),
                                     torch.as_tensor(disp), level, draws)
        np.testing.assert_allclose(g.numpy(), pg, rtol=0, atol=1e-4)
        np.testing.assert_allclose(d.numpy(), pd, rtol=1e-6, atol=0)
        g2, d2 = fx.apply_sensor_noise(torch.as_tensor(gray),
                                       torch.as_tensor(disp), level, draws,
                                       depth=False)
        torch.testing.assert_close(g2, g, rtol=0, atol=0)
        np.testing.assert_array_equal(d2.numpy(), disp)


def test_template_body_is_the_ports():
    v, f, lab = posed_body.make_template()
    pv, pf, pl = port_body.make_template()
    np.testing.assert_array_equal(v, pv)
    np.testing.assert_array_equal(f, pf)
    np.testing.assert_array_equal(lab, pl)
    np.testing.assert_array_equal(
        posed_body.pose_template(v, lab, 15.0, 5.0),
        port_body.pose_template(pv, pl, 15.0, 5.0))


def test_generators_are_seeded_and_sized_alike():
    traffic = dict(sequences=2, frames=3, width=40, height=30, focal=33.0,
                   arc_deg=45.0, arc_offset_deg=1.5, turn_deg=360.0,
                   cam_radius=2.0, radius=0.5, bumps=0.15, n_lat=10,
                   n_lon=16, scale=1.3, yaw_deg=14.3,
                   translation=[0.15, -0.1, 0.2], noise=1.0,
                   depth_noise=True)
    a = bumpy_sphere.generate(traffic, 2 ** 31 + 5, CPU)
    b = bumpy_sphere.generate(traffic, 2 ** 31 + 5, CPU)
    c = bumpy_sphere.generate(traffic, 11, CPU)
    assert a.frames == 6 and len(a.gt) == 2
    torch.testing.assert_close(a.sequences[1].disparity,
                               b.sequences[1].disparity, rtol=0, atol=0)
    assert not torch.equal(a.sequences[1].disparity,
                           c.sequences[1].disparity)
    assert a.sequences[0].disparity.shape == c.sequences[0].disparity.shape
    # the truth is the last sequence's surface; gt[0] maps sequence 0 there
    assert a.gt[0].s == pytest.approx(1.3)
    v, _ = fx.uv_sphere(10, 16, radius=0.5, bumps=0.15)
    np.testing.assert_allclose(a.gt[0].apply(v.astype(np.float64)),
                               a.truth_vertices, atol=1e-6)
