"""View-graph window partitioning: contiguous frame windows plus halos.

PyTorch counterpart of ``multiviewstitch_tpu/parallel/view_windows.py``
(SURVEY §5.7's long-sequence design: each device holds a contiguous frame
window plus ``halo`` boundary frames on each side).

  - ``WindowSpec`` / ``make_window_spec`` / ``edge_window_aligned``: the
    partitioning, host code copied from the JAX package.
  - ``check_consistency_windowed``: the depth-consistency filter on a
    rank's window. The halo frames (disparity and cameras) come from the
    neighbouring ranks in one ``batch_isend_irecv`` (the JAX code uses two
    ``ppermute`` shifts); K1 then runs on the window extended by the halo,
    clipped at the sequence's ends, with offsets +-1..+-halo, and the owned
    frames are kept. A neighbour outside the sequence is outside the
    extended block too, so it casts no vote, as in the global filter: the
    result equals ``check_consistency(offsets=(-halo..-1, 1..halo))`` bit
    for bit.
  - ``check_consistency_sharded``: the whole sequence in, the whole
    filtered sequence out (each rank filters its window; one
    ``all_gather``), the contract of the JAX function on a sharded array.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..core.cameras import CameraBatch
from ..ops.consistency import check_consistency
from .mesh import Mesh, gather_along, shard_along


class WindowSpec(NamedTuple):
    n_frames: int
    n_devices: int
    halo: int

    @property
    def window_len(self) -> int:
        return self.n_frames // self.n_devices

    def window(self, d: int) -> Tuple[int, int]:
        """[start, stop) of device d's owned frames."""
        L = self.window_len
        return d * L, (d + 1) * L

    def working_set(self, d: int) -> Tuple[int, int]:
        """[start, stop) of owned + halo frames (clipped at sequence ends)."""
        s, e = self.window(d)
        return max(0, s - self.halo), min(self.n_frames, e + self.halo)

    def owner_of_frame(self, f) -> int:
        return int(f) // self.window_len

    def owner_of_edge(self, i, j, n2: int) -> int:
        """Edge (i, j) of an n1 x n2 edge grid lives with frame i's window
        (row-major block sharding, as parallel/match_dist.py shards)."""
        return self.owner_of_frame(i)


def make_window_spec(n_frames: int, n_devices: int, halo: int = 1
                     ) -> WindowSpec:
    if n_frames % n_devices:
        raise ValueError(
            f"n_frames={n_frames} must divide over n_devices={n_devices} "
            "(pad the sequence, parallel/mesh.py::pad_to_multiple)")
    return WindowSpec(n_frames, n_devices, halo)


def edge_window_aligned(spec: WindowSpec, n2: int, mesh_size: int) -> bool:
    """True iff block-sharding the row-major edge grid [n1*n2] over
    ``mesh_size`` devices gives every device edges whose i-endpoints fall in
    a single frame window: the edge sharding and the frame-window sharding
    agree, so edge work only touches host-local frames."""
    E = spec.n_frames * n2
    if E % mesh_size:
        return False
    per = E // mesh_size
    for d in range(mesh_size):
        i_lo = (d * per) // n2
        i_hi = ((d + 1) * per - 1) // n2
        if spec.owner_of_frame(i_lo) != spec.owner_of_frame(i_hi):
            return False
    return True


def _pack(disp: torch.Tensor, cams: CameraBatch) -> torch.Tensor:
    """Frames as rows of one float32 tensor: disparity, K, R, t."""
    n = disp.shape[0]
    return torch.cat([disp.reshape(n, -1), cams.K.reshape(n, 9),
                      cams.R.reshape(n, 9), cams.t.reshape(n, 3)], 1)


def _unpack(rows: torch.Tensor, h: int, w: int, width: int, height: int):
    n, hw = rows.shape[0], h * w
    return (rows[:, :hw].reshape(n, h, w),
            CameraBatch(rows[:, hw:hw + 9].reshape(n, 3, 3),
                        rows[:, hw + 9:hw + 18].reshape(n, 3, 3),
                        rows[:, hw + 18:hw + 21].contiguous(), width, height))


def check_consistency_windowed(disp_local: torch.Tensor,
                               cams_local: CameraBatch, *, mesh: Mesh,
                               min_dsp: float, max_dsp: float,
                               reproj_err: float,
                               halo: int = 1) -> torch.Tensor:
    """The consistency filter of this rank's window [L,H,W] (frames
    rank*L .. rank*L+L-1 of the sequence; cameras batch L) against the
    frames at offsets +-1..+-halo, the halo frames taken from the
    neighbouring ranks."""
    L, h, w = disp_local.shape
    if not 1 <= halo <= L:
        raise ValueError(f"halo {halo} must lie in 1..{L} (the window)")
    r, D = mesh.rank, mesh.size
    rows = _pack(disp_local.float(), cams_local)
    ops, left, right = [], None, None
    if r > 0:
        left = torch.empty_like(rows[:halo])
        ops += [dist.P2POp(dist.isend, rows[:halo].contiguous(), r - 1),
                dist.P2POp(dist.irecv, left, r - 1)]
    if r < D - 1:
        right = torch.empty_like(rows[:halo])
        ops += [dist.P2POp(dist.isend, rows[L - halo:].contiguous(), r + 1),
                dist.P2POp(dist.irecv, right, r + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    ext = torch.cat([x for x in (left, rows, right) if x is not None])
    disp_ext, cams_ext = _unpack(ext, h, w, cams_local.width,
                                 cams_local.height)
    offsets = tuple(o for o in range(-halo, halo + 1) if o)
    out = check_consistency(disp_ext, cams_ext, min_dsp=min_dsp,
                            max_dsp=max_dsp, reproj_err=reproj_err,
                            offsets=offsets)
    lo = halo if left is not None else 0
    return out[lo:lo + L]


def check_consistency_sharded(disparity: torch.Tensor, cams: CameraBatch, *,
                              mesh: Mesh, min_dsp: float, max_dsp: float,
                              reproj_err: float,
                              halo: int = 1) -> torch.Tensor:
    """The whole sequence [N,H,W] (N divisible by the mesh size) filtered
    window by window: this rank filters its window, and one ``all_gather``
    returns every window on every rank."""
    n = disparity.shape[0]
    spec = make_window_spec(n, mesh.size, halo)
    s, e = spec.window(mesh.rank)
    local = check_consistency_windowed(
        shard_along(mesh, disparity), cams[s:e].to(mesh.device), mesh=mesh,
        min_dsp=min_dsp, max_dsp=max_dsp, reproj_err=reproj_err, halo=halo)
    return gather_along(mesh, local)
