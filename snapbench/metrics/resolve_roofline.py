"""The least time that resolving the traced batches' reads needs (the
bytes the format fixes, ``rooflines.bytes``, at the card's HBM rate) over
the device time of the resolve layer's kernels, in %. Nothing where the
trace is incomplete, the layer ran no kernel or the card is not in the
table of peaks."""


def read(run):
    tr, pk = run["trace"], run["peaks"]
    busy = tr["layer_s"].get("resolve", 0.0)
    if not (tr["complete"] and pk and busy > 0):
        return None
    return 100.0 * run["bytes"]["trace"]["resolve"] / pk["hbm_bytes_per_s"] / busy
