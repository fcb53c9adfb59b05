"""Benchmark sweep CLI (counterpart of ``naf_tpu/bench/__main__.py``; the
reference's test/ harness UX, test/conftest.py:4-8):

    python -m naf_torch.bench --ratio            # sweep ratios 2..32 on the card
    python -m naf_torch.bench --img-size         # sweep guidance sizes
    python -m naf_torch.bench --embed-dim --models NAF JAFAR --bf16
    python -m naf_torch.bench --large-img --bf16 # backbone + NAF, 896^2 and 1792^2
    python -m naf_torch.bench --ratio --values 4 --models NAF --device cpu

f32 convs and matmuls run in f32 unless ``--tf32`` lets cuDNN and cuBLAS
use TF32; each row records which. Exactly one sweep factor per run (test/test_utils.py:41-43); each row is
printed as one JSON line and merged into ``--out`` (default
``output/torch_bench/results.json``) keyed on (model, factor, dims, dtype).
``benchmarks/results.json`` is the JAX package's TPU record and is not
written here.
"""

import argparse
import json

import torch

from naf_torch.bench.harness import (
    DEFAULT_OUT, LARGE_IMG, MODELS, SWEEPS, benchmark_large_img, run_sweep,
)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m naf_torch.bench")
    for factor in SWEEPS:
        ap.add_argument(
            f"--{factor.replace('_', '-')}", action="store_true",
            help=f"sweep {factor} over {SWEEPS[factor]}",
        )
    ap.add_argument("--large-img", action="store_true",
                    help="end-to-end backbone+NAF rows (896^2/r2, 1792^2/r4)")
    ap.add_argument("--models", nargs="+", default=MODELS)
    ap.add_argument("--values", nargs="+", type=int, default=None)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--no-backward", action="store_true")
    ap.add_argument("--tf32", action="store_true",
                    help="let cuDNN and cuBLAS run f32 convs and matmuls on TF32 (default: off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    if args.large_img:
        for size, ratio in LARGE_IMG:
            rec = benchmark_large_img(size, ratio, dtype=dtype, out_path=args.out,
                                      device=args.device, tf32=args.tf32)
            print(json.dumps(rec), flush=True)
        return

    chosen = [f for f in SWEEPS if getattr(args, f)]
    if len(chosen) != 1:
        ap.error(f"choose exactly one sweep factor of {list(SWEEPS)}")
    run_sweep(
        chosen[0],
        models=args.models,
        values=args.values,
        out_path=args.out,
        dtype=dtype,
        backward=not args.no_backward,
        device=args.device,
        tf32=args.tf32,
    )


if __name__ == "__main__":
    main()
