"""vta_gemm_launches_per_call: ``repro_torch.kernels.ops.launches`` (the
kernel launches ``vta_matmul`` made) over the traced calls, a call."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["launches"]:
        return None
    return tr["launches"] / tr["calls"]
