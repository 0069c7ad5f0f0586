"""The program's own counter: the mean of ``ResolveResult.lookups`` over
the reads of the traced batches (L2 entries the resolver says it
consulted a read)."""


def read(run):
    return run["lookups_per_read"]
