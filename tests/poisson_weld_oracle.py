"""The Z-slab extraction's weld as host numpy (``np.unique`` over the
(z, y, x) cell rows), the oracle the port's device weld is held to bit for
bit. Imports no jax, so the card's tests use it too."""

import numpy as np
import torch

from multiviewstitch_tpu_torch.ops import poisson as TP


def weld_numpy(V, C, F):
    """Weld rows of V sharing a cell row of C (first occurrence kept, rows
    in sorted (z, y, x) order), re-index F and drop faces that collapse.
    Returns (vertices, faces, cells)."""
    uniq, inv = np.unique(C, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    first = np.zeros(len(uniq), np.int64)
    first[inv[::-1]] = np.arange(len(V))[::-1]   # first occurrence
    Vw = V[first]
    Fw = inv[F]
    good = (Fw[:, 0] != Fw[:, 1]) & (Fw[:, 1] != Fw[:, 2]) & \
        (Fw[:, 0] != Fw[:, 2])
    return Vw.astype(np.float32), Fw[good], C[first]


def slabs_numpy(field, occ, origin, spacing, slab):
    """The slab loop with each slab's mesh copied to the host and the
    ownership filter and weld in numpy; the slabs' surface nets run on the
    field's device (``TP._extract_mesh``). Returns (vertices, faces,
    cells)."""
    n_cells = field.shape[0] - 1
    origin_np = origin.cpu().numpy()
    all_v, all_f, all_c = [], [], []
    for z0 in range(0, n_cells, slab):
        z1 = min(z0 + slab, n_cells)
        lo = max(z0 - 1, 0)
        hi = min(z1 + 1, n_cells) + 1
        sub_origin = np.asarray(origin_np, np.float32).copy()
        sub_origin[2] += lo * float(spacing)
        v, f, c = TP._extract_mesh(field[lo:hi], occ[lo:hi],
                                   torch.as_tensor(sub_origin,
                                                   device=field.device),
                                   spacing)
        if len(f) == 0:
            continue
        c = c.astype(np.int64)
        c[:, 0] += lo
        fz = c[f][:, :, 0].min(1)
        keep = (fz >= z0) & (fz < z1) if z1 < n_cells else (fz >= z0)
        base = sum(len(x) for x in all_v)
        all_v.append(v)
        all_c.append(c)
        all_f.append(f[keep] + base)
    return weld_numpy(np.concatenate(all_v), np.concatenate(all_c),
                      np.concatenate(all_f))
