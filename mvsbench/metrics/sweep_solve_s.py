"""Mean seconds a window job spends in the stage sweep_solve_s: the edge
sweep of pipeline.align_seq and solvers.srt. Timed by the traced run's
stage hook between two synchronisations of the card."""


def read(run):
    return run.stage_mean("sweep_solve_s")
