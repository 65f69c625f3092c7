"""Mean seconds a window job spends in the stage tsdf_s: ops.tsdf. Timed by
the traced run's stage hook between two synchronisations of the card."""


def read(run):
    return run.stage_mean("tsdf_s")
