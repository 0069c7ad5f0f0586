"""checkpoint subsystem: delta checkpoints of a pytree on a snapshot chain."""
