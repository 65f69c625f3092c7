"""Mean seconds a window job spends in the stage deform_s:
pipeline.deform_render.deform_stage. Timed by the traced run's stage
hook between two synchronisations of the card."""


def read(run):
    return run.stage_mean("deform_s")
