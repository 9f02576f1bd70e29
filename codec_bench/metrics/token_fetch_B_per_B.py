"""Token bytes the program fetched from the card (its counter
``token_fetch_bytes``) per raw byte of output."""


def read(w):
    fetched = w.counters.get("token_fetch_bytes")
    if w.kind != "inflate" or not fetched or not w.raw_bytes:
        return None
    return fetched / w.raw_bytes
