"""The process's user and system CPU seconds over the window, per GB of
raw output."""


def read(w):
    if w.kind != "inflate" or not w.raw_bytes:
        return None
    return w.cpu_s / (w.raw_bytes / 1e9)
