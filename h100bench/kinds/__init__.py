"""Drivers of the program, one module per traffic ``kind``: each has
``run(config, traffic, seed, seconds, traced, device, t_start) -> dict``."""
