"""vta_alu_roofline: the least time the card could take for the network's
TensorAlu epilogues, as a percentage of the device time of the
``vta_alu`` kernels in the traced calls.

The epilogues are the layers the configuration marks with an ``alu`` key.
Each moves at least its GEMM's int32 result read once, the int32 skip
operand read once where it joins (``join`` in its kind), and the int8
output written once, over the layer's published result (``M · N`` of
``lib/shapes.py``, before any pool) at the cell's batch, at the memory
rate.  Leaving out the bias preload, the port's padding and the pool's
second layout of its rows, it counts less than the kernel moves: the share
can only read low."""

from perfbench.lib import peaks, shapes, trace


def epilogue_bytes(config: dict, batch: int) -> int:
    kinds = {layer["name"]: layer["alu"] for layer in config["layers"]
             if "alu" in layer}
    total = 0
    for name, m, _, n in shapes.gemms(config, batch):
        if name in kinds:
            total += m * n * (4 + (4 if "join" in kinds[name] else 0) + 1)
    return total


def read(rec: dict):
    tr = rec.get("trace")
    peak = peaks.peak(rec["device"]["kind"])
    if not tr or not tr["device"] or peak is None:
        return None
    nbytes = epilogue_bytes(rec["config"], rec["batch"])
    us = trace.device_us(tr, lambda name: "vta_alu" in name)
    if not us or not nbytes:
        return None
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] * tr["calls"] / (us * 1e-6)
