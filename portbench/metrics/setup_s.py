"""setup_s (s, host clock): from the process's start (before torch is
imported) to the first timed request or step: imports, the card's start,
the weights drawn, kernels built or loaded, the warm-up (a training cell's
checked steps among it)."""


def read(run):
    return run.setup_s
