"""Serving layers of the port: :mod:`repro_torch.serving.vta`, the async
engine over compiled VTA networks."""
