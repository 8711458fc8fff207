"""setup_s: seconds from the start of the process to the first timed
step (imports, the card's start, kernel builds on a checkout's first run,
the keys' device contexts and the warm-up of every shape)."""


def read(run):
    return run.setup_s
