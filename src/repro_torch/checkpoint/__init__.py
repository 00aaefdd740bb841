"""Checkpointing (port of the reference's ``checkpoint/``)."""
