"""Raw bytes the inflate entry returned over the whole window, in GB/s."""


def read(w):
    if w.kind != "inflate":
        return None
    return w.raw_bytes / w.window_s / 1e9
