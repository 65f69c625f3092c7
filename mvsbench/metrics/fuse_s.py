"""Mean seconds a window job spends in the stage fuse_s:
pipeline.align_seq.fuse_sequences (K1, K2). Timed by the traced run's
stage hook between two synchronisations of the card."""


def read(run):
    return run.stage_mean("fuse_s")
