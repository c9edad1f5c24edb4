"""Process start to the first timed batch: imports, CUDA start, the
kernels' build or load, the pool made from the seed, the warm-up."""


def read(run):
    return run.setup_s
