"""Share of the profiled job's host span in which no operation ran on the
card: 100 (1 - busy / span)."""


def read(run):
    t = run.trace
    if t is None or t.window_us <= 0 or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
