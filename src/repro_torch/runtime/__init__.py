"""The fault-tolerant training loop (port of the reference's
``runtime/``)."""
