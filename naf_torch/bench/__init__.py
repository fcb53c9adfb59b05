"""The benchmark harness (counterpart of ``naf_tpu/bench``): ``python -m
naf_torch.bench --ratio`` sweeps one factor over the upsampler zoo on the
card; see ``naf_torch.bench.harness``."""

from naf_torch.bench.harness import benchmark_model, run_sweep  # noqa: F401
