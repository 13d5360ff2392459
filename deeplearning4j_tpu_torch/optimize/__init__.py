"""Optimizers: the updaters, and the iteration listeners (``listeners.py``)."""
