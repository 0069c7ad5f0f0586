"""The least time the unprofiled window's batches need (their resolve and
gather bytes at the card's HBM rate) over the window's length, in %: what
bounds a gain still where a later change takes a kernel off the path."""


def read(run):
    pk, win = run["peaks"], run["window"]
    if not pk or win["seconds"] <= 0:
        return None
    need = run["bytes"]["window"]["resolve"] + run["bytes"]["window"]["gather"]
    return 100.0 * need / pk["hbm_bytes_per_s"] / win["seconds"]
