"""The share of the window the encode spent in the host's LZ77 and trees
(the entry's ``fields_s``, summed over the window's calls)."""


def read(w):
    if w.kind != "deflate" or "fields_s" not in w.stages:
        return None
    return 100.0 * w.stages["fields_s"] / w.window_s
