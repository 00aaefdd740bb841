"""Hermetic float front door: seeded torch training + checkpoint import
(DESIGN.md §Quantization).

The port's counterpart of the reference's ``quantize/train.py``.  Two
float models mirror the repo's two int8 topologies exactly — LeNet-5 (the
flat :func:`repro_torch.models.lenet.lenet5_specs` chain) and resnet8 (the
:func:`repro_torch.models.resnet8.build_resnet8` graph) — as ``nn.Module``s
(:class:`LeNet5Net`, :class:`Resnet8Net`) trained on the procedural digit
dataset (:mod:`repro_torch.quantize.digits`) on a torch device, the card
unless the caller names another.

The recipe is the reference's step for step: the same He-initialised
parameters (:func:`init_params`, numpy, bit for bit), the same batch order
(:func:`batch_order`), the mean negative log-likelihood of ``log_softmax``,
gradients by ``torch.autograd`` and the reference's hand-written Adam
(:func:`adam_update`).  Training and :func:`float_top1` run in float32
with TF32 off (:func:`repro_torch.device.strict_float32`).  The two
frameworks' convolutions sum in different orders, so a trajectory of many
steps is not bit-identical across them; the checkpoint format is shared.

Params are flat ``{name: float32 array}`` dicts whose keys equal the
weight-field names of :class:`~repro_torch.models.lenet.LeNetWeights` /
:class:`~repro_torch.models.resnet8.Resnet8Weights` (conv ``OIHW``, fc
``(in, out)``).  ``save_checkpoint``/``load_checkpoint`` write and read
them as the reference's plain ``.npz``, so a checkpoint trained by either
package loads in the other; :func:`params_of` and :func:`float_net` carry
them out of and into a module.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device, strict_float32
from repro_torch.models.lenet import lenet5_forward

NETS = ("lenet5", "resnet8")
NET_CHANNELS = {"lenet5": 1, "resnet8": 3}

# (name, kind, shape) per net — shapes match the int8 models exactly.
_LENET_SHAPES = (
    ("conv1_w", (6, 1, 5, 5)), ("conv1_b", (6,)),
    ("conv2_w", (16, 6, 5, 5)), ("conv2_b", (16,)),
    ("conv3_w", (120, 16, 5, 5)), ("conv3_b", (120,)),
    ("fc4_w", (120, 84)), ("fc4_b", (84,)),
    ("fc5_w", (84, 10)), ("fc5_b", (10,)),
)
_RESNET8_SHAPES = (
    ("stem_w", (16, 3, 3, 3)), ("stem_b", (16,)),
    ("b1a_w", (16, 16, 3, 3)), ("b1a_b", (16,)),
    ("b1b_w", (16, 16, 3, 3)), ("b1b_b", (16,)),
    ("t2a_w", (32, 16, 3, 3)), ("t2a_b", (32,)),
    ("t2p_w", (32, 16, 2, 2)), ("t2p_b", (32,)),
    ("t2b_w", (32, 32, 3, 3)), ("t2b_b", (32,)),
    ("t3a_w", (64, 32, 3, 3)), ("t3a_b", (64,)),
    ("t3p_w", (64, 32, 2, 2)), ("t3p_b", (64,)),
    ("t3b_w", (64, 64, 3, 3)), ("t3b_b", (64,)),
    ("head_w", (64, 64, 1, 1)), ("head_b", (64,)),
    ("fc_w", (64, 10)), ("fc_b", (10,)),
)
_NET_SHAPES = {"lenet5": _LENET_SHAPES, "resnet8": _RESNET8_SHAPES}

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _check_net(net: str) -> None:
    if net not in NETS:
        raise ValueError(f"net must be one of {NETS}, got {net!r}")


def init_params(net: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """He-initialised float32 parameters (numpy, deterministic)."""
    _check_net(net)
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for name, shape in _NET_SHAPES[net]:
        if name.endswith("_b"):
            params[name] = np.zeros(shape, dtype=np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 \
                else shape[0]
            std = np.sqrt(2.0 / fan_in)
            params[name] = rng.normal(0.0, std, shape).astype(np.float32)
    return params


# ---------------------------------------------------------------------------
# Float nets (batched; mirror the int8 topologies node for node)
# ---------------------------------------------------------------------------

def resnet8_forward(p: Mapping[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    """Float logits ``(B, 10)`` for ``(B, 3, 32, 32)`` images — the
    reference's ``resnet8_apply`` op for op (same joins, stride-2
    transitions, k2/s2 projections, GAP head as ``mean((2, 3))``)."""

    def conv(name, x, stride=1, padding=0, relu=True):
        y = F.conv2d(x, p[f"{name}_w"], stride=stride, padding=padding)
        y = y + p[f"{name}_b"][None, :, None, None]
        return torch.relu(y) if relu else y

    v = conv("stem", x, padding=1)
    a = conv("b1a", v, padding=1)
    b = conv("b1b", a, padding=1, relu=False)
    v = torch.relu(b + v)
    a = conv("t2a", v, stride=2, padding=1)
    q = conv("t2p", v, stride=2, relu=False)
    b = conv("t2b", a, padding=1, relu=False)
    v = torch.relu(b + q)
    a = conv("t3a", v, stride=2, padding=1)
    q = conv("t3p", v, stride=2, relu=False)
    b = conv("t3b", a, padding=1, relu=False)
    v = torch.relu(b + q)
    h = conv("head", v)
    g = h.mean((2, 3))
    return g @ p["fc_w"] + p["fc_b"]


class _FloatNet(nn.Module):
    """A float net whose ``nn.Parameter``s carry the reference's names and
    layouts, in the reference's order."""

    net = ""

    def __init__(self, params: Mapping[str, np.ndarray]):
        super().__init__()
        _check_shapes(self.net, params)
        for name, _ in _NET_SHAPES[self.net]:
            self.register_parameter(name, nn.Parameter(torch.tensor(
                np.asarray(params[name], np.float32))))

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())


class LeNet5Net(_FloatNet):
    """Trainable float LeNet-5 (:func:`~repro_torch.models.lenet.
    lenet5_forward`, shared with :class:`~repro_torch.models.lenet.
    LeNet5Float`)."""

    net = "lenet5"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lenet5_forward(self._params(), x)


class Resnet8Net(_FloatNet):
    """Trainable float resnet8 (:func:`resnet8_forward`)."""

    net = "resnet8"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resnet8_forward(self._params(), x)


NET_MODULES = {"lenet5": LeNet5Net, "resnet8": Resnet8Net}


def float_net(net: str, params: Mapping[str, np.ndarray], *,
              device: DeviceLike = None) -> _FloatNet:
    """The float ``nn.Module`` for ``net`` holding ``params`` (a parameter
    dict of either package) on ``device`` — the inverse of
    :func:`params_of`."""
    _check_net(net)
    dev = resolve_device(device)
    return NET_MODULES[net](params).to(dev)


def params_of(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's parameters as a ``{name: float32 array}`` dict on the
    host, the form the reference's functions and checkpoints take."""
    return {name: p.detach().cpu().numpy().astype(np.float32)
            for name, p in module.named_parameters()}


# ---------------------------------------------------------------------------
# Training (the reference's recipe: seeded batch order, hand-written Adam)
# ---------------------------------------------------------------------------

def batch_order(n: int, *, epochs: int, batch: int,
                seed: int) -> Iterator[np.ndarray]:
    """The reference's batches: ``np.random.default_rng(seed + 1)
    .permutation(n)`` each epoch, cut into ``batch``-sized index arrays, the
    ragged last batch dropped."""
    rng = np.random.default_rng(seed + 1)
    for _ in range(epochs):
        order = rng.permutation(n)
        for lo in range(0, n - batch + 1, batch):
            yield order[lo:lo + batch]


def nll_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``log_softmax`` (the reference's
    ``loss_fn``)."""
    logz = torch.log_softmax(logits, dim=1)
    return -torch.gather(logz, 1, labels[:, None]).mean()


@torch.no_grad()
def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                m: List[torch.Tensor], v: List[torch.Tensor], t: int, *,
                lr: float) -> None:
    """One Adam step in place, written as the reference writes it: ``m``
    and ``v`` moments, bias corrections ``1 - b ** t`` taken in float32,
    ``p - lr · (m / mc) / (sqrt(v / vc) + eps)``.  The corrections are
    filled into 0-d tensors on the parameters' device: no copy from the
    host, and a true division (CUDA multiplies by the reciprocal of a host
    scalar divisor)."""
    dev = params[0].device
    mc, vc = (torch.full((), float(1 - np.float32(b) ** np.float32(t)),
                         dtype=torch.float32, device=dev)
              for b in (ADAM_B1, ADAM_B2))
    for p, g, m_k, v_k in zip(params, grads, m, v):
        m_k.copy_(ADAM_B1 * m_k + (1 - ADAM_B1) * g)
        v_k.copy_(ADAM_B2 * v_k + (1 - ADAM_B2) * g ** 2)
        p.copy_(p - lr * (m_k / mc) / (torch.sqrt(v_k / vc) + ADAM_EPS))


def train_float(net: str, images: np.ndarray, labels: np.ndarray, *,
                epochs: int = 6, batch: int = 64, lr: float = 1e-3,
                seed: int = 0, device: DeviceLike = None,
                losses: Optional[list] = None) -> Dict[str, np.ndarray]:
    """Train the float model with seeded shuffling + Adam on ``device``;
    returns the trained parameter dict (numpy float32).  The images, the
    labels and every epoch's batch order move to the device once; batches
    are indexed there.  ``losses``, when given, receives each step's loss
    as a 0-d tensor on the device (appending waits for nothing)."""
    _check_net(net)
    dev = resolve_device(device)
    images = np.asarray(images, np.float32)
    labels = np.asarray(labels, np.int64)
    with strict_float32():
        model = float_net(net, init_params(net, seed), device=dev)
        params = list(model.parameters())
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        steps = list(batch_order(len(images), epochs=epochs, batch=batch,
                                 seed=seed))
        if not steps:
            return params_of(model)
        x_all = torch.from_numpy(images).to(dev)
        y_all = torch.from_numpy(labels).to(dev)
        order = torch.from_numpy(np.stack(steps)).to(dev)
        for t, idx in enumerate(order, start=1):
            loss = nll_loss(model(x_all[idx]), y_all[idx])
            grads = torch.autograd.grad(loss, params)
            if losses is not None:
                losses.append(loss.detach())
            adam_update(params, list(grads), m, v, t, lr=lr)
        return params_of(model)


def float_top1(net: str, params: Dict[str, np.ndarray],
               images: np.ndarray, labels: np.ndarray, *,
               batch: int = 256, device: DeviceLike = None) -> float:
    """Float top-1 accuracy (batched forward on ``device``, TF32 off)."""
    dev = resolve_device(device)
    with strict_float32(), torch.no_grad():
        model = float_net(net, params, device=dev)
        x_all = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
        y_all = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        for lo in range(0, len(images), batch):
            logits = model(x_all[lo:lo + batch])
            correct += (logits.argmax(dim=1) == y_all[lo:lo + batch]).sum()
    return int(correct) / len(images)


# ---------------------------------------------------------------------------
# Checkpoint import path (plain .npz — ONNX/MNIST exports drop in here)
# ---------------------------------------------------------------------------

def _check_shapes(net: str, params: Mapping[str, np.ndarray]) -> None:
    """The reference's name and shape validation, with its messages."""
    _check_net(net)
    want = {name: shape for name, shape in _NET_SHAPES[net]}
    if set(params) != set(want):
        raise ValueError(
            f"checkpoint params {sorted(params)} != {net} topology "
            f"params {sorted(want)}")
    for name, shape in want.items():
        if np.shape(params[name]) != shape:
            raise ValueError(
                f"checkpoint param {name!r} has shape "
                f"{np.shape(params[name])}, {net} expects {shape}")


def save_checkpoint(path, params: Dict[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v, np.float32)
                      for k, v in params.items()})


def load_checkpoint(path,
                    net: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Load a ``.npz`` float checkpoint; with ``net`` given, validate
    the parameter names and shapes against the topology."""
    with np.load(path) as z:
        params = {k: np.asarray(z[k], np.float32) for k in z.files}
    if net is not None:
        _check_shapes(net, params)
    return params


def train_or_load(net: str, *, checkpoint=None, train_n: int = 4000,
                  epochs: int = 6, batch: int = 64, lr: float = 1e-3,
                  seed: int = 0, device: DeviceLike = None
                  ) -> Dict[str, np.ndarray]:
    """The front door: load ``checkpoint`` if it exists, else train on
    the procedural digit dataset on ``device`` (and save to
    ``checkpoint`` when a path is given) — hermetic either way."""
    from .digits import digit_dataset
    _check_net(net)
    if checkpoint is not None and pathlib.Path(checkpoint).exists():
        return load_checkpoint(checkpoint, net)
    dev = resolve_device(device)
    images, labels = digit_dataset(train_n, seed=seed, split="train",
                                   channels=NET_CHANNELS[net])
    params = train_float(net, images, labels, epochs=epochs, batch=batch,
                         lr=lr, seed=seed, device=dev)
    if checkpoint is not None:
        save_checkpoint(checkpoint, params)
    return params
