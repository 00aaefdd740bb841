"""Deterministic synthetic training data (port of the reference's
``data/``)."""
