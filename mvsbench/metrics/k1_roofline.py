"""K1's least time (roofline/k1.py, from each call's disparity) over its
device time in the profiled job, in %. Silent unless the job launched it
once per sequence."""

from mvsbench.roofline import k1


def read(run):
    if run.trace is None:
        return None
    us, calls = run.trace.kernel_time(k1.KERNELS)
    seqs = run.scene.sequences
    if us <= 0 or calls != len(seqs):
        return None
    s = run.cell.config["settings"]
    least = sum(k1.bound(f.disparity, s["MinDsp"], s["MaxDsp"])
                for f in seqs)
    return 100.0 * least / (us * 1e-6)
