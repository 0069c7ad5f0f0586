"""The least time the unprofiled window's batches need (their resolve and
gather bytes, and in a mix that writes their write bytes, at the card's
HBM rate) over the window's length, in %: what bounds a gain still where
a later change takes a kernel off the path. Nothing where the resolve
bytes are not countable (``rooflines.bytes``)."""


def read(run):
    pk, win, need = run["peaks"], run["window"], run["bytes"]["window"]
    if not pk or win["seconds"] <= 0 or need["resolve"] is None:
        return None
    total = need["resolve"] + need["gather"] + need.get("write", 0.0)
    return 100.0 * total / pk["hbm_bytes_per_s"] / win["seconds"]
