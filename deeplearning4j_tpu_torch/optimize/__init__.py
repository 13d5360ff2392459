"""Optimizers (the updaters so far)."""
