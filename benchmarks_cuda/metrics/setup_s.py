"""setup_s: from the start of the process to the cell's readiness to
serve: the corpus drawn from the seed, the index built, the kernels
loaded (built on a checkout's first run), the warm-up batches served."""


def read(run):
    return run.setup_s
