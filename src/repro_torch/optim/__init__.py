"""Optimizers (port of the reference's ``optim/``)."""
