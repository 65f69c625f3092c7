"""Mean seconds a window job spends in the stage prep_s: the prep of
pipeline.match_edges (segment, view synthesis, SIFT). Timed by the
traced run's stage hook between two synchronisations of the card."""


def read(run):
    return run.stage_mean("prep_s")
