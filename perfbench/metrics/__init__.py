"""One reader a per-layer metric, each in ``<metric>.py`` with
``read(record) -> float | None``: the metric's value from the run's
record (``lib/harness.py``), or None where the record holds nothing to
read (the harness then leaves the metric out of the result)."""
