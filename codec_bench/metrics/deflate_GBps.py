"""Raw bytes the encode entry compressed over the whole window, in GB/s."""


def read(w):
    if w.kind != "deflate":
        return None
    return w.raw_bytes / w.window_s / 1e9
