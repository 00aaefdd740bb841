"""The benchmark's general code: the manifest, the traffic generator, the
seeded weights, the shape arithmetic, the trace reduction, the comparison
and the run itself."""
