"""vta_gemm_roofline: the least time the card could take for the
network's GEMMs, as a percentage of the device time of the ``vta_gemm``
kernels in the traced calls.

The GEMMs are the configuration's published shapes at the cell's batch
(``lib/shapes.py``).  A GEMM's least time is the larger of its bytes at
the memory rate, each operand read once and the int8 output and int32
bias written and read once, and its ``2·M·K·N`` operations at the int8
rate (the bound of ``chip_smoke.bound``, frozen here).  Counting the
output as int8 where a layer's kernel writes int32 for the epilogue, and
leaving out the port's padding, both count less than the kernel moves:
the share can only read low."""

from perfbench.lib import peaks, shapes, trace


def bound_s(m: int, k: int, n: int, peak: dict) -> float:
    nbytes = m * k + k * n + 4 * n + m * n
    return max(nbytes / peak["hbm_bytes_per_s"],
               2 * m * k * n / peak["int8_ops_per_s"])


def read(rec: dict):
    tr = rec.get("trace")
    peak = peaks.peak(rec["device"]["kind"])
    if not tr or not tr["device"] or peak is None:
        return None
    us = trace.device_us(tr, lambda name: "vta_gemm" in name)
    if not us:
        return None
    per_call = sum(bound_s(m, k, n, peak)
                   for _, m, k, n in shapes.gemms(rec["config"], rec["batch"]))
    return 100.0 * per_call * tr["calls"] / (us * 1e-6)
