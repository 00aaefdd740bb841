"""The port's fault injector and integrity guards against the reference's.

``repro_torch.harden`` copies the reference's injector and guards with
their imports changed; the serves they drive run on the port's torch
interpreters (``device="cpu"`` here) and its ``cuda`` backend (the plain
version on the CPU).  Tolerance 0 throughout:

* ``FaultInjector(seed).plan`` draws the reference's ``FaultSpec``\\ s,
  draw for draw, for every fault class on LeNet-5 and resnet8 (both
  packages compile the same programs);
* the reference's ``tests/test_harden.py`` cases hold on the port;
* a small seeded campaign — the reference's arms in the reference's
  order, 3 injections a class with the guards on and 2 with them off —
  gives the reference's outcome and ``GuardReport`` for every injection on
  both models;
* an SRAM flip lands on a torch buffer exactly as on a numpy one.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.network_compiler as jnc                        # noqa: E402
import repro.harden as jh                                        # noqa: E402
import repro.harden.faults as jfaults                            # noqa: E402
import repro.harden.guards as jguards                            # noqa: E402
import repro.models.lenet as jlenet                              # noqa: E402
import repro_torch.core.network_compiler as tnc                  # noqa: E402
import repro_torch.harden as th                                  # noqa: E402
import repro_torch.harden.faults as tfaults                      # noqa: E402
import repro_torch.harden.guards as tguards                      # noqa: E402
import repro_torch.models.lenet as tlenet                        # noqa: E402
from repro_torch.core import isa                                 # noqa: E402
from repro_torch.core.gemm_compiler import (AluImmOp,            # noqa: E402
                                            compile_matmul)
from repro_torch.core.simulator import run_program               # noqa: E402
from repro_torch.harden import (FAULT_CLASSES, FaultInjector,    # noqa: E402
                                GuardPolicy, Watchdog,
                                WatchdogTimeout, capture_golden,
                                restore_network, validate_network,
                                validate_program, verify_network)
from repro_torch.harden.faults import estimate_footprint         # noqa: E402

CPU = dict(device="cpu")
IMG = tlenet.synthetic_digit(1)


def _lenet(nc, lenet):
    return nc.compile_network(lenet.lenet5_specs(
        lenet.lenet5_random_weights(0)), lenet.synthetic_digit(0))


@pytest.fixture(scope="module")
def lenet():
    net = _lenet(tnc, tlenet)
    tguards.golden_of(net)          # snapshot while known good
    return net


@pytest.fixture(scope="module")
def golden_out(lenet):
    return lenet.serve_one(IMG, **CPU)


@pytest.fixture(scope="module")
def pairs():
    """model -> (port net, reference net, request image, dual backend):
    the reference campaign's workloads (its ``_build_lenet`` and
    ``_build_resnet8``)."""
    import repro.models.resnet8 as j8
    import repro_torch.models.resnet8 as t8
    return {
        "lenet5": (_lenet(tnc, tlenet), _lenet(jnc, jlenet),
                   jlenet.synthetic_digit(1), "oracle"),
        "resnet8": (t8.compile_resnet8()[0], j8.compile_resnet8()[0],
                    j8.synthetic_image(1), "fast"),
    }


# ---------------------------------------------------------------------------
# The injector draws the reference's plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["lenet5", "resnet8"])
def test_fault_plans_equal_reference(pairs, model):
    tnet, jnet, _, _ = pairs[model]
    tinj, jinj = FaultInjector(seed=2026), jh.FaultInjector(seed=2026)
    for cls in FAULT_CLASSES:
        for _ in range(12):
            want = dataclasses.asdict(jinj.plan(jnet, cls))
            assert dataclasses.asdict(tinj.plan(tnet, cls)) == want
    assert tfaults.FAULT_CLASSES == jfaults.FAULT_CLASSES
    assert tfaults.DRAM_CLASSES == jfaults.DRAM_CLASSES
    assert tguards.MAX_INSN_FOOTPRINT == jguards.MAX_INSN_FOOTPRINT
    assert th.__all__ == jh.__all__


@pytest.mark.parametrize("buffer", ["uop", "inp", "wgt", "acc", "out"])
def test_sram_flip_on_torch_buffers(lenet, buffer):
    """A flip on the interpreters' torch buffers (and the host UOP
    scratchpad) equals the reference's flip on numpy buffers, single-image
    and batched, at every bit of the element's width."""
    from repro.core.fast_simulator import BatchFastSimulator as JB
    from repro.core.fast_simulator import FastSimulator as JF
    from repro_torch.core.fast_simulator import BatchFastSimulator as TB
    from repro_torch.core.fast_simulator import FastSimulator as TF
    rng = np.random.default_rng(3)
    image = lenet.dram_image()
    stack = np.stack([image, image])
    sims = [(JF(lenet.config, image), TF(lenet.config, image, **CPU)),
            (JB(lenet.config, stack), TB(lenet.config, stack, **CPU))]
    for js, ts in sims:
        jbuf, tbuf = getattr(js, f"{buffer}_buf"), getattr(ts, f"{buffer}_buf")
        vals = rng.integers(-2 ** 7, 2 ** 7, jbuf.shape).astype(jbuf.dtype)
        jbuf[...] = vals
        if isinstance(tbuf, torch.Tensor):
            tbuf.copy_(torch.from_numpy(vals))
        else:
            tbuf[...] = vals
        for offset, bit in [(0, 0), (5, 7), (17, 31), (1000, 13), (3, 30)]:
            jfaults._flip_sram(js, buffer, offset, bit)
            tfaults._flip_sram(ts, buffer, offset, bit)
        got = tbuf.numpy() if isinstance(tbuf, torch.Tensor) else tbuf
        np.testing.assert_array_equal(got, jbuf)


# ---------------------------------------------------------------------------
# The reference's harden cases on the port
# ---------------------------------------------------------------------------

def test_clean_guarded_serve_is_clean(lenet, golden_out):
    out, rep = lenet.serve_one(IMG, guard=GuardPolicy(), backend="fast",
                               **CPU)
    assert rep.outcome == "clean" and rep.detections == 0
    np.testing.assert_array_equal(out, golden_out)


def test_capture_refuses_corrupted_program(lenet):
    prog = lenet.layers[0].program
    original = prog.segments["wgt"]
    data = bytearray(original)
    data[0] ^= 0x10
    prog.segments["wgt"] = bytes(data)     # SEU: bypasses set_segment
    try:
        with pytest.raises(ValueError, match="refusing to snapshot"):
            capture_golden(lenet)
    finally:
        prog.segments["wgt"] = original


def test_verify_names_the_corrupted_layer_segment(lenet):
    golden = capture_golden(lenet)
    assert verify_network(lenet, golden) == []
    prog = lenet.layers[2].program
    data = bytearray(prog.segments["uop"])
    data[3] ^= 0x01
    prog.segments["uop"] = bytes(data)
    assert verify_network(lenet, golden) == [f"{prog.name}:uop"]
    assert restore_network(lenet, golden, layers=[2]) == 1
    assert verify_network(lenet, golden) == []


@pytest.mark.parametrize("fault_class",
                         ["dram-wgt", "dram-uop", "dram-bias", "insn-bits"])
def test_persistent_faults_detected_and_recovered(lenet, golden_out,
                                                  fault_class):
    inj = FaultInjector(seed=101)
    for _ in range(5):
        spec, hook = inj.inject(lenet, fault_class)
        if fault_class == "insn-bits":
            try:
                inj.materialize(lenet, spec)
            except ValueError:
                pass
        out, rep = lenet.serve_one(IMG, guard=GuardPolicy(), backend="fast",
                                   fault_hook=hook, **CPU)
        assert rep.outcome == "recovered", spec.describe()
        assert rep.crc_failures, spec.describe()
        np.testing.assert_array_equal(out, golden_out)


def test_insn_field_mutation_caught_by_roundtrip(lenet, golden_out):
    inj = FaultInjector(seed=55)
    for _ in range(5):
        spec, hook = inj.inject(lenet, "insn-field")
        out, rep = lenet.serve_one(IMG, guard=GuardPolicy(), backend="fast",
                                   fault_hook=hook, **CPU)
        assert rep.outcome == "recovered", spec.describe()
        assert rep.validation_errors and not rep.crc_failures
        np.testing.assert_array_equal(out, golden_out)


def test_sram_transients_never_corrupt_output(lenet, golden_out):
    inj = FaultInjector(seed=77)
    policy = GuardPolicy(dual_execute=True, dual_backend="fast")
    outcomes = set()
    for _ in range(30):
        spec, hook = inj.inject(lenet, "sram")
        out, rep = lenet.serve_one(IMG, guard=policy, backend="fast",
                                   fault_hook=hook, **CPU)
        assert out is not None, spec.describe()
        np.testing.assert_array_equal(out, golden_out)
        outcomes.add(rep.outcome)
    assert outcomes <= {"clean", "recovered"}


def test_guarded_batched_serve_recovers(lenet):
    inj = FaultInjector(seed=9)
    imgs = [tlenet.synthetic_digit(s) for s in range(3)] + [IMG]
    plain, _ = lenet.serve(imgs, **CPU)
    inj.inject(lenet, "dram-wgt")
    outs, sims, reps = lenet.serve(imgs, backend="batched",
                                   guard=GuardPolicy(), **CPU)
    assert len(reps) == 4 and all(r.outcome == "recovered" for r in reps)
    assert len(sims) == len(lenet.layers)
    np.testing.assert_array_equal(outs, plain)


def test_guarded_batched_dual_execution_against_the_kernel(lenet):
    """The shadow of a dual-executed guarded batch is the network's
    default serve — the ``cuda`` backend (its plain version here)."""
    from repro_torch.kernels import ref as tref
    imgs = [tlenet.synthetic_digit(s) for s in range(4)]
    calls = []
    real = tref.vta_gemm_ref
    tref.vta_gemm_ref = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        outs, _, reps = lenet.serve(imgs, backend="batched", **CPU,
                                    guard=GuardPolicy(dual_execute=True))
    finally:
        tref.vta_gemm_ref = real
    assert len(calls) == len(lenet.layers)          # the shadow only
    assert all(r.outcome == "clean" and r.dual_mismatches == 0
               for r in reps)
    np.testing.assert_array_equal(outs, lenet.serve(imgs, **CPU)[0])


def test_unrecoverable_returns_none_not_garbage(lenet):
    def always_corrupt(sim, layer_idx, insn_idx):
        prog = lenet.layers[0].program
        data = bytearray(prog.segments["wgt"])
        data[0] ^= 0xFF
        prog.segments["wgt"] = bytes(data)

    out, rep = lenet.serve_one(IMG, guard=GuardPolicy(max_retries=2),
                               backend="fast", fault_hook=always_corrupt,
                               **CPU)
    assert out is None and rep.outcome == "failed" and not rep.ok
    assert rep.retries == 2
    restore_network(lenet, lenet._harden_golden)
    outs, sims, reps = lenet.serve([IMG, IMG], backend="batched", **CPU,
                                   guard=GuardPolicy(max_retries=1),
                                   fault_hook=always_corrupt)
    assert outs is None and sims == []
    assert [r.outcome for r in reps] == ["failed", "failed"]
    restore_network(lenet, lenet._harden_golden)


def test_injector_is_deterministic(lenet):
    plans = []
    for _ in range(2):
        inj = FaultInjector(seed=2026)
        plans.append([inj.plan(lenet, cls).describe()
                      for cls in FAULT_CLASSES for _ in range(4)])
    assert plans[0] == plans[1]
    other = [FaultInjector(seed=2027).plan(lenet, cls).describe()
             for cls in FAULT_CLASSES for _ in range(4)]
    assert other != plans[0]


def test_watchdog_trips_on_deadline():
    wd = Watchdog(0.05)
    try:
        wd.arm()
        wd.check()
        time.sleep(0.2)
        with pytest.raises(WatchdogTimeout):
            wd.check()
        wd.arm()
        wd.check()
    finally:
        wd.stop()


def test_watchdog_policy_fails_hung_serve(lenet):
    def hung(sim, layer_idx, insn_idx):
        time.sleep(0.15)

    policy = GuardPolicy(deadline_s=0.2, max_retries=0)
    out, rep = lenet.serve_one(IMG, guard=policy, backend="fast",
                               fault_hook=hung, **CPU)
    assert out is None and rep.watchdog_tripped
    assert rep.outcome == "failed"


def test_saturation_counter_counts_clipped_lanes():
    rng = np.random.default_rng(0)
    A = rng.integers(-128, 128, (8, 32)).astype(np.int8)
    B = rng.integers(-128, 128, (32, 8)).astype(np.int8)
    prog = compile_matmul(A, B)
    out_plain, rep = run_program(prog, backend="fast", count_overflows=True,
                                 **CPU)
    assert rep.acc_saturation_lanes > 0
    assert rep.acc_overflow_lanes == 0
    out_off, rep_off = run_program(prog, backend="fast", **CPU)
    np.testing.assert_array_equal(out_plain, out_off)
    assert rep_off.acc_saturation_lanes == 0


def test_overflow_counter_counts_wrapped_accumulators():
    A = np.full((1, 16), 127, dtype=np.int8)
    B = np.full((16, 16), 127, dtype=np.int8)
    X = np.full((1, 16), 2 ** 31 - 1, dtype=np.int32)
    prog = compile_matmul(A, B, X=X)
    for backend in ("oracle", "fast", "batched"):
        _, rep = run_program(prog, backend=backend, count_overflows=True,
                             **CPU)
        assert rep.acc_overflow_lanes > 0, backend


def _random_matmul(rng):
    m, k, n = (int(rng.integers(1, 40)) for _ in range(3))
    A = rng.integers(-128, 128, (m, k)).astype(np.int8)
    B = rng.integers(-128, 128, (k, n)).astype(np.int8)
    ops = [AluImmOp.relu()] if rng.random() < 0.5 else []
    return compile_matmul(A, B, alu_ops=ops)


def test_validator_accepts_clean_programs_seeded():
    rng = np.random.default_rng(42)
    for _ in range(15):
        prog = _random_matmul(rng)
        validate_program(prog)
        out_a, _ = run_program(prog, backend="fast", **CPU)
        out_b, _ = run_program(prog, backend="fast", count_overflows=True,
                               **CPU)
        np.testing.assert_array_equal(out_a, out_b)


def test_validator_accepts_clean_network(lenet):
    assert validate_network(lenet) == []


def test_dual_execution_bit_identical_when_clean(lenet, golden_out):
    out, rep = lenet.serve_one(
        IMG, guard=GuardPolicy(dual_execute=True, dual_backend="oracle"),
        backend="fast", **CPU)
    assert rep.outcome == "clean" and rep.dual_mismatches == 0
    np.testing.assert_array_equal(out, golden_out)


def test_footprint_estimate_flags_geometry_bombs(lenet):
    for layer in lenet.layers:
        assert (estimate_footprint(layer.program.instructions)
                <= tguards.MAX_INSN_FOOTPRINT)
    bomb = isa.GemInsn(uop_bgn=0, uop_end=2 ** 14 - 1, iter_out=2 ** 14 - 1,
                       iter_in=2 ** 14 - 1)
    assert estimate_footprint([bomb]) > tguards.MAX_INSN_FOOTPRINT


# ---------------------------------------------------------------------------
# A small seeded campaign: the reference's arms, injection for injection
# ---------------------------------------------------------------------------

def _classify(out, golden, report) -> str:
    if out is None:
        return "unrecovered"
    if not np.array_equal(out, golden):
        return "sdc"
    return "recovered" if report.detections else "masked"


def campaign(net, image, dual_backend, H, G, n_on, n_off, serve_kw):
    """``benchmarks/fault_campaign.py``'s ``_guarded_arm`` then
    ``_unguarded_arm`` from one injector, logging every injection: its
    plan, outcome and (guards on) ``GuardReport``."""
    inj = H.FaultInjector(seed=2026)
    golden_out = net.serve_one(image, **serve_kw.get("golden", {}))
    golden = G.golden_of(net)
    log = []
    for cls in H.FAULT_CLASSES:
        policy = H.GuardPolicy(dual_execute=(cls == "sram"),
                               dual_backend=dual_backend)
        for _ in range(n_on):
            spec, hook = inj.inject(net, cls)
            if cls == "insn-bits":
                try:
                    inj.materialize(net, spec)
                except ValueError:
                    pass
            out, rep = net.serve_one(image, guard=policy, fault_hook=hook,
                                     **serve_kw["serve"])
            log.append((spec.describe(), _classify(out, golden_out, rep),
                        dataclasses.asdict(rep)))
            G.restore_network(net, golden)
    for cls in H.FAULT_CLASSES:
        for _ in range(n_off):
            spec, hook = inj.inject(net, cls)
            decode_failed = False
            if cls == "insn-bits":
                try:
                    inj.materialize(net, spec)
                except ValueError:
                    decode_failed = True
            bomb = any(H.faults.estimate_footprint(l.program.instructions)
                       > G.MAX_INSN_FOOTPRINT for l in net.layers)
            if decode_failed:
                outcome = "detected"
            elif bomb:
                outcome = "hang"
            else:
                try:
                    out = net.serve_one(image, fault_hook=hook,
                                        **serve_kw["serve"])
                except Exception:                       # noqa: BLE001
                    outcome = "detected"
                else:
                    outcome = ("masked" if np.array_equal(out, golden_out)
                               else "sdc")
            log.append((spec.describe(), outcome))
            G.restore_network(net, golden)
    return log


@pytest.mark.parametrize("model", ["lenet5", "resnet8"])
def test_campaign_matches_reference(pairs, model):
    tnet, jnet, image, dual = pairs[model]
    want = campaign(jnet, image, dual, jh, jguards, 3, 2, {"serve": {}})
    got = campaign(tnet, image, dual, th, tguards, 3, 2,
                   {"golden": CPU, "serve": dict(backend="fast", **CPU)})
    assert len(got) == len(want) == 5 * len(FAULT_CLASSES)
    for g, w in zip(got, want):
        assert g == w
    guarded = [entry[1] for entry in got[:3 * len(FAULT_CLASSES)]]
    assert "sdc" not in guarded and "unrecovered" not in guarded


@pytest.mark.parametrize("fault_class", ["dram-wgt", "dram-bias"])
def test_every_backend_serves_the_segments_as_they_are(pairs, fault_class):
    """A segment replaced by an upset (and then restored) reaches every
    backend's next serve — the device image is rebuilt, not reused — so
    the unguarded answers are the reference's corrupted ones."""
    tnet, jnet, _, _ = pairs["lenet5"]
    images = [tlenet.synthetic_digit(s) for s in range(3)]
    golden, _ = tnet.serve(images, **CPU)
    tgold, jgold = tguards.golden_of(tnet), jguards.golden_of(jnet)
    visible = 0
    for seed in range(6):
        tinj, jinj = FaultInjector(seed=seed), jh.FaultInjector(seed=seed)
        tinj.inject(tnet, fault_class)
        jinj.inject(jnet, fault_class)
        want, _ = jnet.serve(images)
        visible += not np.array_equal(want, golden)
        for backend in ("cuda", "batched"):
            got, _ = tnet.serve(images, backend=backend, **CPU)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tnet.serve_one(images[0], backend="fast", **CPU), want[0])
        restore_network(tnet, tgold)
        jguards.restore_network(jnet, jgold)
        np.testing.assert_array_equal(tnet.serve(images, **CPU)[0], golden)
    assert visible                       # some upsets change the answers
