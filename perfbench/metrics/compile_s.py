"""compile_s: seconds of the set-up's compile, from the seeded weights and
calibration images to the compiled ``NetworkProgram`` (graph, calibration,
layer and GEMM compilers), on the host clock."""


def read(rec: dict):
    return rec.get("compile_s")
