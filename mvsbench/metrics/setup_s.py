"""From the start of the process to the end of the warm-up job."""


def read(run):
    return run.setup_s
