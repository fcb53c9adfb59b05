"""The readings the denoiser cell's limits are set from, taken on the card
at the cell's own size, in one process (``h100bench.calibrate`` for the
``denoise`` kind, whose control table it does not list):

    python3 -m h100bench.calibrate_denoise --workload CELL --seeds S1 S2 ... \\
        --control-seeds C1 C2 C3 [--faults F1 F2 F3] [--f32-top N] --out FILE

- the program's numbers on each of ``--seeds``: a run of the cell with no
  window beyond its first steps, judged as a run judges them
  (``calibrate._program``);
- the control's on each of ``--control-seeds``: the reference computed in
  float8 (``check.fp8``) against the float32 reference, on the same steps;
- with ``--faults``, on those seeds, the program with each fault that
  ``FAULTS`` plants;
- with ``--f32-top N``, the program with an f32 working copy on the N of
  ``--seeds`` whose bf16 ``grad_gap`` or ``delta_gap`` read highest: what
  of those gaps the working precision makes.

Prints one JSON line per reading and a summary (the program's highest
reading of each number, the control's and each fault's lowest) and writes
them all to ``--out``. The benchmark's own runs never run this; the tests
plant the same ``FAULTS`` on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from h100bench.calibrate import _program
from h100bench.kinds import denoise
from h100bench.run import load_cell


@contextlib.contextmanager
def _loss(alter):
    """The program's loss replaced by ``alter(loss, self, pred, target)``."""
    from naf_torch.evals.denoising import DenoisingLoss

    full = DenoisingLoss.__call__
    DenoisingLoss.__call__ = lambda self, pred, target: alter(full, self, pred, target)
    try:
        yield
    finally:
        DenoisingLoss.__call__ = full


def half_batch():
    """Each step's loss over the first half of the batch."""
    return _loss(lambda full, self, p, t: full(self, p[: p.shape[0] // 2], t[: t.shape[0] // 2]))


def rows_swapped():
    """The batch's first two predictions swapped before the loss."""
    return _loss(lambda full, self, p, t: full(self, p[[1, 0, *range(2, p.shape[0])]], t))


def half_batch_backward():
    """The loss reported whole, its gradient taken from the first half of
    the batch alone: the other half's terms are missing from the backward,
    as a batch-index fault in a backward kernel would leave them."""

    def alter(full, self, p, t):
        out = dict(full(self, p, t))
        half = full(self, p[: p.shape[0] // 2], t[: t.shape[0] // 2])["total"] / 2
        out["total"] = out["total"].detach() + (half - half.detach())
        return out

    return _loss(alter)


def _one_pct_high(full, self, p, t):
    out = dict(full(self, p, t))
    out["total"] = 1.01 * out["total"]
    return out


def loss_altered():
    """The loss 1% high."""
    return _loss(_one_pct_high)


@contextlib.contextmanager
def state_unchanged():
    """AdamW's step a no-op: the masters and the moments stay as drawn."""
    import naf_torch.train.denoise as train_denoise

    made = train_denoise.make_optimizer

    def frozen(model, cfg):
        opt = made(model, cfg)
        opt.step = lambda closure=None: None
        return opt

    train_denoise.make_optimizer = frozen
    try:
        yield
    finally:
        train_denoise.make_optimizer = made


@contextlib.contextmanager
def noise_params_dropped():
    """The noise drawn without its parameters: the generator's default
    sigma (0.1) instead of the configuration's."""
    from naf_torch.evals.denoising import NoiseGenerator

    full = NoiseGenerator.__call__
    NoiseGenerator.__call__ = lambda self, gen, image, noise_params=None: full(self, gen, image)
    try:
        yield
    finally:
        NoiseGenerator.__call__ = full


# each fault, and the number it takes above that number's limit (the tests hold it so)
FAULTS = {"rows_swapped": (rows_swapped, "loss_fn_gap"),
          "half_batch": (half_batch, "loss_fn_gap"),
          "half_batch_backward": (half_batch_backward, "grad_rel_l2"),
          "loss_altered": (loss_altered, "loss_fn_gap"),
          "state_unchanged": (state_unchanged, "grad_gap"),
          "noise_params_dropped": (noise_params_dropped, "noise_z")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench.calibrate_denoise")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--f32-top", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_denoise: no CUDA card", file=sys.stderr)
        return 3
    cell, config, traffic, _ = load_cell(args.workload)
    if traffic["kind"] != "denoise":
        print(f"calibrate_denoise: {cell['name']} is of kind {traffic['kind']!r}; "
              "use h100bench.calibrate", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    readings = []

    def record(what, seed, fn):
        t0 = time.time()
        nums = fn()
        rec = {"cell": cell["name"], "what": what, "seed": seed, "numbers": nums,
               "s": time.time() - t0}
        readings.append(rec)
        print(json.dumps(rec), flush=True)

    def faulty(fault, seed):
        with FAULTS[fault][0]():
            return _program(cell, config, traffic, seed, dev)

    f32 = {**config, "train": {**config["train"], "use_bf16": False}}
    for s in args.seeds:
        record("program", s, lambda: _program(cell, config, traffic, s, dev))
    worst = sorted((r for r in readings if r["what"] == "program"),
                   key=lambda r: -max(r["numbers"]["grad_gap"], r["numbers"]["delta_gap"]))
    for r in worst[:args.f32_top]:
        record("program_f32", r["seed"], lambda: _program(cell, f32, traffic, r["seed"], dev))
    for s in args.control_seeds:
        record("control", s, lambda: denoise.control_numbers(config, traffic, s, dev))
    for fault in FAULTS:
        for s in args.faults:
            record(fault, s, lambda: faulty(fault, s))
    summary = {}
    for what in ("program", "program_f32", "control", *FAULTS):
        rs = [r["numbers"] for r in readings if r["what"] == what]
        if rs:
            agg = max if what.startswith("program") else min
            summary[what] = {k: agg(r[k] for r in rs) for k in rs[0]}
    print(json.dumps({"cell": cell["name"], "summary": summary,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    with open(args.out, "w") as f:
        json.dump({"readings": readings, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
