"""The VTA compiler (numpy, copied from the reference) and the CUDA backend."""
