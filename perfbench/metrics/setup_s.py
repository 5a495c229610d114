"""Process start to the window's opening: loading, drawing the weights,
building the kernels on a checkout's first run, warming the cell's
shapes, and a serve cell's preroll."""


def read(rec):
    return rec.setup_s
