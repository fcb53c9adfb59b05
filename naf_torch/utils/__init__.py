from naf_torch.utils.benchmarking import device_time_ms  # noqa: F401
