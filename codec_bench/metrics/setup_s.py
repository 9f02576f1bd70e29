"""Process start to the window's start: data made from the seed, CUDA
start-up, the program's builds or loads, warm-up of the cell's own calls."""


def read(w):
    return w.setup_s
