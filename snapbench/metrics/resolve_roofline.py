"""The least time that resolving the traced batches' reads needs (the
bytes the format fixes, ``rooflines.bytes``, at the card's HBM rate) over
the device time of the resolve layer's kernels, in %. Nothing where the
trace is incomplete, the layer ran no kernel, the card is not in the
table of peaks, or the bytes are not countable (``rooflines.bytes``)."""


def read(run):
    tr, pk = run["trace"], run["peaks"]
    busy = tr["layer_s"].get("resolve", 0.0)
    need = run["bytes"]["trace"]["resolve"]
    if not (tr["complete"] and pk and busy > 0) or need is None:
        return None
    return 100.0 * need / pk["hbm_bytes_per_s"] / busy
