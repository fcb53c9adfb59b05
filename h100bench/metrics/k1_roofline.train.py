"""K1's share of its roofline in the training step, read as k1_roofline
reads it, from the kernels that ``k1_roofline.kernels/`` names."""

from h100bench.metrics.k1_roofline import read  # noqa: F401
