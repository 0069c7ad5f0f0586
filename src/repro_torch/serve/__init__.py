"""serve subsystem."""
