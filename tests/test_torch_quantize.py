"""The port's float front door and PTQ harness against the reference's.

The same numpy inputs, drawn from seeds, go through both packages
(``repro.quantize`` in JAX on the CPU, ``repro_torch.quantize`` with
``device="cpu"``):

* the digit dataset and ``init_params`` are bit-identical;
* the float forwards of LeNet-5, resnet8 and the CIFAR CNN agree within
  atol = rtol = 1e-5; the loss and gradients of one batch within rtol 1e-4,
  atol 1e-6 of ``jax.grad``; one Adam update on identical gradients within
  1e-7 of the reference's ``train_float`` step; the batches train in the
  same order;
* ``.npz`` checkpoints written by either package load in the other, with
  the same name and shape errors;
* a JAX-trained checkpoint quantised by both packages gives the same
  exponents, shifts and calibration set, and its int8 logits served on the
  CPU equal the reference's batched serve bit for bit;
* ``evaluate_net`` runs end to end on the CPU at the reference test's size.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp                                          # noqa: E402

import repro.models.cifar_cnn as jcifar                          # noqa: E402
import repro.quantize as jq                                      # noqa: E402
import repro.quantize.train as jtrain                            # noqa: E402
import repro_torch.models.cifar_cnn as tcifar                    # noqa: E402
import repro_torch.models.lenet as tlenet                        # noqa: E402
import repro_torch.quantize as tq                                # noqa: E402
import repro_torch.quantize.train as ttrain                      # noqa: E402
from repro_torch.device import strict_float32                    # noqa: E402

CHANNELS = {"lenet5": 1, "resnet8": 3}
FWD_TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_loss(net):
    apply_fn = jtrain.APPLY_FNS[net]

    def loss_fn(p, x, y):
        logz = jax.nn.log_softmax(apply_fn(p, x))
        return -jnp.take_along_axis(logz, y[:, None], axis=1).mean()
    return loss_fn


@pytest.fixture(scope="module")
def jax_trained():
    """The reference's ``train_float`` at the smoke size (96 images, one
    epoch: one Adam step of 64), per net."""
    out = {}
    for net in tq.NETS:
        x, y = jq.digit_dataset(96, seed=0, split="train",
                                channels=CHANNELS[net])
        out[net] = jtrain.train_float(net, x, y, epochs=1, seed=0)
    return out


# ---------------------------------------------------------------------------
# Dataset and initial parameters: bit-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "test", "calib"])
@pytest.mark.parametrize("channels", [1, 3])
def test_digit_dataset_identical(split, channels):
    tx, ty = tq.digit_dataset(24, seed=5, split=split, channels=channels)
    jx, jy = jq.digit_dataset(24, seed=5, split=split, channels=channels)
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("net", ["lenet5", "resnet8"])
@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_identical(net, seed):
    tp, jp = tq.init_params(net, seed), jq.init_params(net, seed)
    assert list(tp) == list(jp)
    for k in jp:
        assert tp[k].dtype == jp[k].dtype == np.float32
        np.testing.assert_array_equal(tp[k], jp[k])


# ---------------------------------------------------------------------------
# Float forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["lenet5", "resnet8"])
def test_float_forward_matches_jax(net, jax_trained):
    """Initial and JAX-trained parameters run in the port's module within
    atol = rtol = 1e-5 of the reference's apply function."""
    x, _ = jq.digit_dataset(16, seed=3, split="test", channels=CHANNELS[net])
    for params in (jq.init_params(net, 1), jax_trained[net]):
        want = np.asarray(jax.jit(jtrain.APPLY_FNS[net])(params, x))
        model = tq.float_net(net, params, device="cpu")
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (16, 10)
        np.testing.assert_allclose(got, want, **FWD_TOL)


def test_cifar_float_forward_matches_jax():
    """``reference_forward_float`` over float weights (the integer weights
    scaled so the logits are O(1)), one image and a batch."""
    iw = jcifar.cifar_cnn_random_weights(seed=0)
    scale = {"conv1_w": 2.0 ** -8, "conv2_w": 2.0 ** -9,
             "conv3_w": 2.0 ** -9, "fc4_w": 2.0 ** -10, "fc5_w": 2.0 ** -3}
    arrays = {k: (v * scale[k] if k in scale else v * 2.0 ** -10)
              .astype(np.float32) for k, v in dataclasses.asdict(iw).items()}
    jw = jcifar.CifarCNNWeights(**arrays)
    tw = tcifar.CifarCNNWeights(**arrays)
    images = [jcifar.synthetic_cifar_image(s).astype(np.float32) / 64.0
              for s in range(4)]
    got = tcifar.reference_forward_float(tw, np.concatenate(images),
                                         device="cpu")
    for i, img in enumerate(images):
        want = jcifar.reference_forward_float(jw, img)
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got[i:i + 1], want, **FWD_TOL)
        np.testing.assert_allclose(
            tcifar.reference_forward_float(tw, img, device="cpu"), want,
            **FWD_TOL)


def test_lenet5_float_and_trainable_share_one_forward():
    """``LeNet5Float`` (int8 weights as buffers) and the trainable
    ``LeNet5Net`` run the same function: equal logits on equal values."""
    w = tlenet.lenet5_random_weights(seed=2)
    arrays = dataclasses.asdict(w)
    x = torch.from_numpy(tq.digit_dataset(4, seed=2)[0])
    net = tq.float_net("lenet5", {k: v.astype(np.float32)
                                  for k, v in arrays.items()}, device="cpu")
    with torch.no_grad():
        assert torch.equal(tlenet.LeNet5Float(arrays)(x), net(x))
        assert torch.equal(tlenet.lenet5_forward(
            dict(net.named_parameters()), x), net(x))


# ---------------------------------------------------------------------------
# Training: loss, gradients, one Adam update, batch order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["lenet5", "resnet8"])
def test_loss_and_gradients_match_jax(net):
    params = jq.init_params(net, 4)
    x, y = jq.digit_dataset(32, seed=4, channels=CHANNELS[net])
    loss_j, grads_j = jax.jit(jax.value_and_grad(_jax_loss(net)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(y.astype(np.int32)))
    model = tq.float_net(net, params, device="cpu")
    loss = ttrain.nll_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4,
                               atol=1e-6)
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(grads_j[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("net", ["lenet5", "resnet8"])
def test_adam_update_matches_reference_step(net):
    """The reference's ``train_float`` over exactly one batch is one Adam
    step from ``init_params``; the port's ``adam_update`` on the same
    gradients (the reference's, under ``jax.jit``) lands within 1e-7."""
    n = 32
    x, y = jq.digit_dataset(n, seed=6, channels=CHANNELS[net])
    after = jtrain.train_float(net, x, y, epochs=1, batch=n, seed=9)
    idx = next(ttrain.batch_order(n, epochs=1, batch=n, seed=9))
    p0 = jq.init_params(net, 9)
    grads_j = jax.jit(jax.grad(_jax_loss(net)))(
        {k: jnp.asarray(v) for k, v in p0.items()}, jnp.asarray(x[idx]),
        jnp.asarray(y[idx].astype(np.int32)))
    model = tq.float_net(net, p0, device="cpu")
    params = list(model.parameters())
    names = [name for name, _ in model.named_parameters()]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    ttrain.adam_update(params, [torch.from_numpy(np.array(grads_j[k]))
                                for k in names], m, v, 1, lr=1e-3)
    got = tq.params_of(model)
    moved = 0
    for k in names:
        np.testing.assert_allclose(got[k], after[k], rtol=0, atol=1e-7,
                                   err_msg=k)
        moved += int((after[k] != p0[k]).sum())
    assert moved > 0.5 * sum(p.size for p in p0.values())


def test_batch_order_identical(monkeypatch):
    """The batches each package trains on, in order: pixel [0, 0, 0] of
    image i holds i, and both packages' training loops are watched."""
    n, batch, epochs = 50, 8, 3
    x, y = jq.digit_dataset(n, seed=1)
    x = x.copy()
    x[:, 0, 0, 0] = np.arange(n)
    ref_batches = []
    real_jit = jax.jit

    def watching_jit(fn):
        jitted = real_jit(fn)

        def step(p, m, v, t, xb, yb):
            ref_batches.append(np.asarray(xb)[:, 0, 0, 0].astype(int))
            return jitted(p, m, v, t, xb, yb)
        return step

    monkeypatch.setattr(jax, "jit", watching_jit)
    jtrain.train_float("lenet5", x, y, epochs=epochs, batch=batch, seed=3)
    monkeypatch.setattr(jax, "jit", real_jit)

    port_batches = []

    class Watched(ttrain.LeNet5Net):
        def forward(self, xb):
            port_batches.append(xb[:, 0, 0, 0].detach().numpy().astype(int))
            return super().forward(xb)

    monkeypatch.setitem(ttrain.NET_MODULES, "lenet5", Watched)
    tq.train_float("lenet5", x, y, epochs=epochs, batch=batch, seed=3,
                   device="cpu")
    assert len(ref_batches) == epochs * (n // batch) == len(port_batches)
    for r, p, o in zip(ref_batches, port_batches,
                       ttrain.batch_order(n, epochs=epochs, batch=batch,
                                          seed=3)):
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(o, r)


def test_strict_float32_scope_restores_flags():
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             b.cudnn.benchmark, b.cudnn.deterministic)
    with strict_float32():
        assert not b.cudnn.allow_tf32 and not b.cuda.matmul.allow_tf32
        assert not b.cudnn.benchmark and b.cudnn.deterministic
    assert (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
            b.cudnn.benchmark, b.cudnn.deterministic) == saved


# ---------------------------------------------------------------------------
# Checkpoints cross the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["lenet5", "resnet8"])
def test_checkpoints_load_in_the_other_package(tmp_path, net):
    tparams = tq.train_float(net, *jq.digit_dataset(
        64, seed=2, channels=CHANNELS[net]), epochs=1, seed=2,
        device="cpu")
    jparams = jq.init_params(net, 8)
    tq.save_checkpoint(tmp_path / "t.npz", tparams)
    jq.save_checkpoint(tmp_path / "j.npz", jparams)
    for params, path in ((tparams, "t.npz"), (jparams, "j.npz")):
        for load in (tq.load_checkpoint, jq.load_checkpoint):
            back = load(tmp_path / path, net)
            assert list(back) == list(params)
            for k in params:
                np.testing.assert_array_equal(back[k], params[k])
    # a torch-trained dict runs in the reference, and back
    x, _ = jq.digit_dataset(8, seed=2, split="test", channels=CHANNELS[net])
    with torch.no_grad():
        got = tq.float_net(net, tparams, device="cpu")(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jtrain.APPLY_FNS[net](tparams, x)), **FWD_TOL)
    assert tq.params_of(tq.float_net(net, jparams, device="cpu")).keys() \
        == jparams.keys()


@pytest.mark.parametrize("fault", ["names", "shape"])
def test_checkpoint_errors_match(tmp_path, fault):
    params = jq.init_params("lenet5")
    if fault == "names":
        params = {"mystery_w": np.zeros((2, 2), np.float32)}
    else:
        params["conv1_w"] = np.zeros((6, 1, 3, 3), np.float32)
    path = tmp_path / "bad.npz"
    jq.save_checkpoint(path, params)
    with pytest.raises(ValueError) as jerr:
        jq.load_checkpoint(path, "lenet5")
    with pytest.raises(ValueError) as terr:
        tq.load_checkpoint(path, "lenet5")
    assert str(terr.value) == str(jerr.value)
    assert ("topology" if fault == "names" else "conv1_w") in str(terr.value)
    with pytest.raises(ValueError) as merr:
        tq.float_net("lenet5", params, device="cpu")
    assert str(merr.value) == str(jerr.value)


def test_train_or_load_prefers_existing_checkpoint(tmp_path):
    params = jq.init_params("resnet8", seed=9)
    path = tmp_path / "ckpt.npz"
    jq.save_checkpoint(path, params)
    loaded = tq.train_or_load("resnet8", checkpoint=str(path))
    for k in params:                      # loaded, not re-trained
        np.testing.assert_array_equal(loaded[k], params[k])


# ---------------------------------------------------------------------------
# PTQ + serve of a JAX-trained checkpoint in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["lenet5", "resnet8"])
def test_quantised_checkpoint_serves_identically(net, jax_trained):
    params = jax_trained[net]
    ch = CHANNELS[net]
    calib_x, _ = jq.digit_dataset(8, seed=0, split="calib", channels=ch)
    test_x, test_y = jq.digit_dataset(24, seed=0, split="test", channels=ch)
    tqm = tq.quantize_network(tq.float_model(net, params), calib_x, margin=0)
    jqm = jq.quantize_network(jq.float_model(net, params), calib_x, margin=0)
    assert tqm.kind == jqm.kind
    assert tqm.weight_exps == jqm.weight_exps
    assert tqm.shifts == jqm.shifts
    assert len(tqm.calib_int) == len(jqm.calib_int) == 8
    for a, b in zip(tqm.calib_int, jqm.calib_int):
        np.testing.assert_array_equal(a, b)
    tprog, jprog = tqm.compile(), jqm.compile()
    ints = tq.quantize_images(test_x, input_exp=tqm.input_exp)
    np.testing.assert_array_equal(
        ints, jq.quantize_images(test_x, input_exp=jqm.input_exp))
    tout, _ = tprog.serve(ints, device="cpu")
    jout, _ = jprog.serve(ints, backend="batched")
    assert tout.dtype == jout.dtype == np.int8
    np.testing.assert_array_equal(tout, jout)
    assert tq.int8_top1(tprog, test_x, test_y, batch=16, device="cpu") == \
        jq.int8_top1(jprog, test_x, test_y, batch=16)
    assert tq.backend_agreement(tprog, test_x[:4], device="cpu")


def test_evaluate_net_smoke(tmp_path):
    """The reference test's size (``tests/test_quantize.py``), on the CPU;
    the record carries the reference's keys, the spot-check named for
    what it compares."""
    rec = tq.evaluate_net("lenet5", train_n=96, eval_n=24, calib_n=8,
                          epochs=1, batch=16, spotcheck_n=4,
                          checkpoint=str(tmp_path / "smoke.npz"),
                          device="cpu")
    jkeys = {"net", "n_train", "n_eval", "n_calib", "float_top1",
             "int8_top1", "delta_points", "pallas_spotcheck_bit_identical",
             "weight_exps", "shifts"}
    assert set(rec) == jkeys - {"pallas_spotcheck_bit_identical"} | {
        "device_vs_cpu_spotcheck_bit_identical"}
    assert rec["net"] == "lenet5" and rec["n_eval"] == 24
    assert 0.0 <= rec["float_top1"] <= 1.0
    assert 0.0 <= rec["int8_top1"] <= 1.0
    assert rec["device_vs_cpu_spotcheck_bit_identical"] is True
    assert set(rec["shifts"]) == set(rec["weight_exps"])
    # the checkpoint was written, satisfies the topology contract, and the
    # reference loads it
    jq.load_checkpoint(tmp_path / "smoke.npz", "lenet5")
    tq.load_checkpoint(tmp_path / "smoke.npz", "lenet5")


def test_quantize_eval_driver_on_cpu(capsys):
    from repro_torch import quantize_eval
    rc = quantize_eval.main(["--net", "lenet5", "--train-n", "64",
                             "--eval-n", "16", "--calib-n", "4",
                             "--epochs", "1", "--batch", "8",
                             "--device", "cpu"])
    row = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("lenet5")]
    assert len(row) == 1 and row[0].endswith("bit-identical")
    # the gate is the reference's: the 2-decimal delta against 2 points
    delta = float(row[0].split()[3])
    assert rc == (0 if delta <= tq.GATE_POINTS else 1)
