"""Dataset-scale accuracy harness (EXPERIMENTS.md §Accuracy).

The port's counterpart of the reference's ``quantize/evaluate.py``: a
held-out digit split is served through ``NetworkProgram.serve`` on the
card — one ``vta_gemm`` launch per layer per stack — and int8-vs-float
top-1 is reported.  The reference's spot-check compares two of its
backends; the port has one, so :func:`backend_agreement` compares the
serve on the card with the serve on ``device="cpu"`` (the kernel against
its plain version) on real quantised-from-float weights.  ``evaluate_net``
is the one-call pipeline ``python -m repro_torch.quantize_eval`` drives:
train-or-load float weights → PTQ → compile → serve the test split →
accuracy record.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

from .digits import digit_dataset
from .models import CHANNELS, float_model
from .ptq import INPUT_EXP, quantize_images, quantize_network
from .train import float_top1, train_or_load

# The accuracy gate: int8 top-1 within this many points of float top-1.
GATE_POINTS = 2.0


def int8_top1(net_prog, images: np.ndarray, labels: np.ndarray, *,
              input_exp: int = INPUT_EXP, batch: int = 64,
              backend: str = "cuda", device: DeviceLike = None) -> float:
    """Top-1 accuracy of a compiled network over float images, served
    on ``device`` in ``batch``-sized stacks."""
    dev = resolve_device(device)
    ints = quantize_images(images, input_exp=input_exp)
    correct = 0
    for lo in range(0, len(ints), batch):
        chunk = ints[lo:lo + batch]
        outs, _ = net_prog.serve(chunk, backend=backend, device=dev)
        preds = outs.reshape(len(chunk), -1).argmax(axis=1)
        correct += int((preds == labels[lo:lo + len(chunk)]).sum())
    return correct / len(ints)


def backend_agreement(net_prog, images: np.ndarray, *,
                      input_exp: int = INPUT_EXP,
                      device: DeviceLike = None) -> bool:
    """Bit-identity spot-check: the stack served on ``device`` (the card:
    ``vta_gemm``) gives the same bytes as on ``device="cpu"`` (its plain
    version)."""
    dev = resolve_device(device)
    ints = quantize_images(images, input_exp=input_exp)
    outs, _ = net_prog.serve(ints, device=dev)
    plain, _ = net_prog.serve(ints, device="cpu")
    return bool(np.array_equal(outs, plain))


def evaluate_net(net: str, *, train_n: int = 4000, eval_n: int = 2000,
                 calib_n: int = 64, epochs: int = 6, seed: int = 0,
                 batch: int = 64, margin: int = 0,
                 checkpoint: Optional[str] = None,
                 spotcheck_n: int = 8,
                 device: DeviceLike = None) -> Dict[str, object]:
    """Float front door → PTQ → dataset-scale serve, one call, on
    ``device`` (the card unless the caller names another).

    Returns the reference's accuracy record: float and int8 top-1 on the
    ``eval_n``-image held-out split, the delta in points, and the
    spot-check verdict under ``device_vs_cpu_spotcheck_bit_identical``.

    ``margin=0`` by default: the §4.2 scan already sizes each shift so
    the full calibration-set accumulator range fits int8 exactly, and an
    extra guard octave costs real accuracy (one bit of logit resolution
    per layer — measured ~4 points of top-1 on LeNet-5 digits).
    """
    dev = resolve_device(device)
    channels = CHANNELS[net]
    params = train_or_load(net, checkpoint=checkpoint, train_n=train_n,
                           epochs=epochs, seed=seed, device=dev)
    test_x, test_y = digit_dataset(eval_n, seed=seed, split="test",
                                   channels=channels)
    calib_x, _ = digit_dataset(calib_n, seed=seed, split="calib",
                               channels=channels)
    facc = float_top1(net, params, test_x, test_y, device=dev)
    qm = quantize_network(float_model(net, params), calib_x, margin=margin)
    prog = qm.compile()
    iacc = int8_top1(prog, test_x, test_y, input_exp=qm.input_exp,
                     batch=batch, device=dev)
    agree = backend_agreement(prog, test_x[:spotcheck_n],
                              input_exp=qm.input_exp, device=dev)
    return {
        "net": net,
        "n_train": train_n,
        "n_eval": eval_n,
        "n_calib": calib_n,
        "float_top1": facc,
        "int8_top1": iacc,
        "delta_points": (facc - iacc) * 100.0,
        "device_vs_cpu_spotcheck_bit_identical": bool(agree),
        "weight_exps": {k: int(v) for k, v in qm.weight_exps.items()},
        "shifts": {k: int(v) for k, v in qm.shifts.items()},
    }
