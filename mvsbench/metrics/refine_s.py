"""Mean seconds a window job spends in the stage refine_s:
pipeline.ba_refine / solvers.ba. Timed by the traced run's stage hook
between two synchronisations of the card."""


def read(run):
    return run.stage_mean("refine_s")
