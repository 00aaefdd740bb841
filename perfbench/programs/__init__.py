"""How the port builds the system under test for a configuration: one
file a configuration, ``<config>.py`` with ``compile(config, weights,
calib)``, which returns a compiled ``repro_torch`` ``NetworkProgram``."""
