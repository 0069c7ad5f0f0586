"""Host ms a batch spends inside ``fleet.read``, from the call until it
returns (no synchronize): the harness's span around each call of the
unprofiled window, averaged over every batch."""


def read(run):
    host = run["window"]["host_s"]
    return 1e3 * sum(host) / len(host) if host else None
