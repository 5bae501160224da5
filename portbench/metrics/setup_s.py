"""``setup_s``: process start to the window's start (host clock): the
interpreter, PyTorch and the card, the kernels loaded (built, in a first
run), the stream, the sample and the plan, and the cell's warm-up."""


def read(run):
    return run.setup_s
