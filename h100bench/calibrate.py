"""The readings a cell's limits are set from, taken on the card at the
cell's own size, in one process:

    python3 -m h100bench.calibrate --workload CELL --seeds S1 S2 ... \\
        --control-seeds C1 C2 C3 [--faults F1 F2 F3] --out FILE

- the program's numbers on each of ``--seeds``: a run of the cell with no
  window beyond its checked calls (inference) or its first steps
  (training), judged as a run judges them;
- the control's on each of ``--control-seeds``: the reference put in the
  program's place and computed in float8 (``check.fp8``), against the
  float32 reference, on the same requests or steps;
- with ``--faults`` (training), the program with half of each batch left
  out of the loss, the mean taken over the rest, on those seeds.

Prints one JSON line per reading and a summary (the program's highest
reading of each number, the control's and each fault's lowest) and writes
them all to ``--out``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from h100bench import check
from h100bench.run import load_cell


def _program(cell, config, traffic, seed, device):
    from h100bench.run import run_cell

    return run_cell(cell, config, traffic, seed, 0.0, False, device, limits={})["numbers"]


def _control_upsample(config, traffic, seed, device):
    from h100bench.kinds import upsample

    prog = upsample.build(config, traffic, seed, device)
    del prog.ups
    torch.cuda.empty_cache()
    pairs = []
    for c in prog.checked:
        j = int(prog.order[c % len(prog.order)])
        args = (config, prog.state, prog.images[j], prog.feats[j], prog.out_hw)
        ref = upsample.reference_output(*args)
        pairs.append((upsample.reference_output(*args, q8=check.fp8), ref))
    return upsample.numbers(pairs)


def _control_distill(config, traffic, seed, device):
    from h100bench.kinds import distill
    from h100bench.reference.distill import distill_steps
    from h100bench.weights import subseed

    prog = distill.Program(config, traffic, seed, device)
    rows = [next(prog.feed) for _ in range(traffic["checked_steps"])]
    batches = [prog.stack.index_select(0, torch.as_tensor(r, device=device)) for r in rows]
    naf_init, teacher = prog.naf_init, prog.teacher_state
    del prog
    torch.cuda.empty_cache()
    ref = distill_steps(naf_init, teacher, config, batches, subseed(seed, "rope"))
    losses, grad1, delta = distill_steps(naf_init, teacher, config, batches, subseed(seed, "rope"),
                                         q8=check.fp8)
    params = {k: naf_init[k] + delta[k] for k in delta}
    return distill.numbers(losses, grad1, params, naf_init, ref)


def _half_batch(cell, config, traffic, seed, device):
    """The program with each step's loss over the first half of the batch."""
    import naf_torch.train.trainer as trainer

    orig = trainer.mse_loss

    def half(pred, target, normalize=False):
        n = pred.shape[0] // 2
        return orig(pred[:n], target[:n], normalize)

    trainer.mse_loss = half
    try:
        return _program(cell, config, traffic, seed, device)
    finally:
        trainer.mse_loss = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell, config, traffic, _ = load_cell(args.workload)
    kind = traffic["kind"]
    control = {"upsample": _control_upsample, "distill": _control_distill}[kind]
    dev = torch.device("cuda")
    readings = []

    def record(what, seed, fn):
        t0 = time.time()
        nums = fn()
        rec = {"cell": cell["name"], "what": what, "seed": seed, "numbers": nums,
               "s": time.time() - t0}
        readings.append(rec)
        print(json.dumps(rec), flush=True)

    for s in args.seeds:
        record("program", s, lambda: _program(cell, config, traffic, s, dev))
    for s in args.control_seeds:
        record("control", s, lambda: control(config, traffic, s, dev))
    for s in args.faults:
        record("half_batch", s, lambda: _half_batch(cell, config, traffic, s, dev))
    summary = {}
    for what in ("program", "control", "half_batch"):
        rs = [r["numbers"] for r in readings if r["what"] == what]
        if rs:
            agg = max if what == "program" else min
            summary[what] = {k: agg(r[k] for r in rs) for k in rs[0]}
    print(json.dumps({"cell": cell["name"], "summary": summary,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    with open(args.out, "w") as f:
        json.dump({"readings": readings, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
