"""Post-training quantization + accuracy validation (DESIGN.md
§Quantization, EXPERIMENTS.md §Accuracy), on a torch device.

The port's counterpart of the reference's ``quantize`` package, in three
stages:

* :mod:`repro_torch.quantize.digits` — the deterministic procedurally
  generated MNIST-like digit dataset (a copy: every image is a pure
  function of ``(seed, split, index)``);
* :mod:`repro_torch.quantize.train`  — the float front door: seeded torch
  training of float LeNet-5/resnet8 ``nn.Module``s on the card (the
  reference's recipe step for step, TF32 off) + the ``.npz`` checkpoint
  import path, which both packages read and write;
* :mod:`repro_torch.quantize.ptq` / :mod:`repro_torch.quantize.evaluate` —
  the model-agnostic :func:`quantize_network` PTQ pipeline (a copy) and
  the dataset-scale harness that serves the held-out split through
  ``vta_gemm`` on the card and spot-checks it against the plain version.
"""

from .digits import digit_dataset, digit_image                  # noqa: F401
from .evaluate import (GATE_POINTS, backend_agreement,           # noqa: F401
                       evaluate_net, int8_top1)
from .models import float_model, lenet5_float_layers, \
    resnet8_float_graph                                          # noqa: F401
from .ptq import (INPUT_EXP, FloatLayer, QuantizedModel,         # noqa: F401
                  calibrate_integer_weight_exps, choose_weight_exp,
                  quantize_bias, quantize_images, quantize_network,
                  quantize_weights)
from .train import (NETS, float_net, float_top1,                 # noqa: F401
                    init_params, load_checkpoint, params_of,
                    save_checkpoint, train_float, train_or_load)
