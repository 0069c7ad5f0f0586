"""The least time that gathering the traced batches needs (each distinct
found cluster read once, every output cluster written, at the card's HBM
rate) over the device time of the gather layer's kernel (K5), in %."""


def read(run):
    tr, pk = run["trace"], run["peaks"]
    busy = tr["layer_s"].get("gather", 0.0)
    if not (tr["complete"] and pk and busy > 0):
        return None
    return 100.0 * run["bytes"]["trace"]["gather"] / pk["hbm_bytes_per_s"] / busy
