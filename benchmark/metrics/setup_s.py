"""From process start to the window's start: the kernels' build on a
checkout's first run, the weights, the ring, the warmup and one training
iteration."""


def read(run):
    return run.setup_s
