"""K3's least time (roofline/k3.py) over its device time in the profiled
job, in %: ``render`` draws deform.obj, mapped by the inverse of each
sequence's SRT.txt similarity, into that sequence's cameras, one call a
sequence; the projected vertices are worked out again here. Silent unless
the job made one call a sequence."""

import os

import torch

from mvsbench import reference
from mvsbench.geometry import Mat
from mvsbench.raster import project_vertices
from mvsbench.roofline import k3


def read(run):
    if run.trace is None or run.traced_job is None:
        return None
    us, _ = run.trace.kernel_time(k3.KERNELS)
    _, calls = run.trace.kernel_time(k3.CALLS)
    seqs = run.scene.sequences
    res = os.path.join(run.traced_job.workdir, "Result")
    if us <= 0 or calls != len(seqs) or not os.path.isdir(res):
        return None
    verts, faces = reference.read_obj(os.path.join(res, "deform.obj"))
    srt = reference.read_srt(os.path.join(res, "SRT.txt"))
    least = 0.0
    for f, T in zip(seqs, srt):
        v = torch.as_tensor(T.inverse().apply(verts.astype("float64")),
                            dtype=torch.float32, device=f.cams.K.device)
        fc = torch.as_tensor(faces, device=v.device)
        uvz, ok = project_vertices(v, fc, f.cams, Mat())
        least += k3.bound(uvz, fc.int(), ok, f.cams.height, f.cams.width)
    return 100.0 * least / (us * 1e-6)
