"""Plain references of the semantics the configurations state."""
