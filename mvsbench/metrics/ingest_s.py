"""Mean seconds a window job spends in the stage ingest_s: pipeline.ingest
(io.native_loader). Timed by the traced run's stage hook between two
synchronisations of the card."""


def read(run):
    return run.stage_mean("ingest_s")
