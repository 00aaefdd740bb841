"""Entry points of the port's LM stack: :mod:`repro_torch.launch.serve`."""
