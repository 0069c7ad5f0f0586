"""kvcache subsystem."""
