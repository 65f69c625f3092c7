"""Mean seconds a window job spends in the stage poisson_s: ops.poisson.
Timed by the traced run's stage hook between two synchronisations of the
card."""


def read(run):
    return run.stage_mean("poisson_s")
