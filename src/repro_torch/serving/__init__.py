"""Serving layers of the port: :mod:`repro_torch.serving.vta`, the async
engine over compiled VTA networks, and the LM serving path
(:mod:`repro_torch.serving.cache`, :mod:`repro_torch.serving.engine`)."""
