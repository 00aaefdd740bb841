"""vta_alu_device_ms_per_kimg: device milliseconds of every TensorAlu
epilogue kernel (a kernel whose name holds ``vta_alu``: the joins, the
pools and the GAP tree of the layers that do not fuse into ``vta_gemm``)
per 1,000 images served in the traced calls."""

from perfbench.lib import trace


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    us = trace.device_us(tr, lambda name: "vta_alu" in name)
    if not us:
        return None
    return us / 1e3 / (tr["images"] / 1e3)
