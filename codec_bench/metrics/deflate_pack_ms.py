"""The bit-pack on the card a call (the entry's ``pack_s``, summed over the
window's calls, over the calls), in ms."""


def read(w):
    if w.kind != "deflate" or "pack_s" not in w.stages or not w.calls:
        return None
    return 1e3 * w.stages["pack_s"] / w.calls
