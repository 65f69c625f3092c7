"""Mean seconds a window job spends in the stage trim_write_s:
solvers.unionfind and the io.meshio writers. Timed by the traced run's
stage hook between two synchronisations of the card."""


def read(run):
    return run.stage_mean("trim_write_s")
