"""Input frames of the window's completed jobs over the time from the
first job's start to the last job's end (host clock)."""


def read(run):
    done = run.done
    if not done:
        return None
    span = max(j.end for j in done) - min(j.start for j in run.jobs)
    return run.scene.frames * len(done) / span if span > 0 else None
