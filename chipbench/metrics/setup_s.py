"""setup_s (s): process start to the first timed round, by the host
clock: import, the kernels built or loaded, data and weights made from
the seed, the server built and the check block, which warms every shape
the window uses."""


def read(rec):
    return rec.setup_s
