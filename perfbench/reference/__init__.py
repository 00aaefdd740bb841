"""The plain references: the integer networks worked out again in plain
PyTorch from the seeded weights and calibration images, shifts included.
Nothing here imports the port or the JAX package."""
