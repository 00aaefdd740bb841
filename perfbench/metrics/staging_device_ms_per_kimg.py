"""staging_device_ms_per_kimg: device milliseconds of every operation that
is not a ``vta_gemm`` kernel (the DRAM stack's clone, staging, the codecs,
the TensorAlu epilogue, copies), per 1,000 images served in the traced
calls."""

from perfbench.lib import trace


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    us = trace.device_us(tr, lambda name: "vta_gemm" not in name)
    return us / 1e3 / (tr["images"] / 1e3)
