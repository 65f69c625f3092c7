"""K2's least time (roofline/k2.py, from each call's shapes) over its
device time in the profiled job, in %. Silent unless the job launched it
once per sequence."""

from mvsbench.roofline import k2


def read(run):
    if run.trace is None:
        return None
    us, calls = run.trace.kernel_time(k2.KERNELS)
    seqs = run.scene.sequences
    if us <= 0 or calls != len(seqs):
        return None
    s = run.cell.config["settings"]
    least = sum(k2.bound(*f.disparity.shape, s["PtSampRds"], s["NbrFrmNum"],
                         s["NbrFrmStep"]) for f in seqs)
    return 100.0 * least / (us * 1e-6)
