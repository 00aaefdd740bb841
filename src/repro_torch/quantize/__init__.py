"""Quantization helpers of the port.

Only the integer-weight calibration the graph models use is here
(:func:`~repro_torch.quantize.ptq.calibrate_integer_weight_exps`); the
float front door of the reference's ``quantize`` package (training,
``quantize_network``, the digit dataset) is not ported yet.
"""

from .ptq import calibrate_integer_weight_exps                   # noqa: F401
