"""Optimizers: AdamW with f32 state."""
