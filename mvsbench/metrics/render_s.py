"""Mean seconds a window job spends in the stage render_s:
pipeline.deform_render.render_stage (K3, the raster writes). Timed by
the traced run's stage hook between two synchronisations of the card."""


def read(run):
    return run.stage_mean("render_s")
