"""The readings the limits of the cells whose reference does not fit whole
are set from: the DINOv3 ViT-7B/16 cell (``vfm_upsample``: the reference
ViT a block's weights at a time beside the program's 13.4 GB) and the
streamed 4096^2 cell (``streamed``: the reference in blocks of rows). Taken
on the card at the cell's own size, in one process
(``h100bench.calibrate``'s control reads a whole reference):

    python3 -m h100bench.calibrate_large --workload CELL --seeds S1 S2 ... \\
        --control-seeds C1 C2 C3 [--faults F1 F2 F3] --out FILE

- the program's numbers on each of ``--seeds``: a run of the cell with no
  window beyond its checked calls, judged as a run judges them
  (``calibrate._program``);
- the control's on each of ``--control-seeds``: the reference computed in
  float8 (``check.fp8``) against the float32 reference, on the same
  requests;
- with ``--faults``, on those seeds, the program with each fault of the
  cell's kind in ``FAULTS`` planted.

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
import torch.nn.functional as F

from h100bench import check
from h100bench.calibrate import _program
from h100bench.run import load_cell

__all__ = ["FAULTS", "control", "main"]


@contextlib.contextmanager
def _patched(owner, name: str, make):
    """``owner.name`` replaced by ``make(original)`` inside the block."""
    full = getattr(owner, name)
    setattr(owner, name, make(full))
    try:
        yield
    finally:
        setattr(owner, name, full)


def last_block_dropped():
    """The backbone's forward without its last block."""
    from naf_torch.backbones.vit import ViT

    def make(full):
        def forward(self, x):
            blocks = self.blocks
            self.blocks = blocks[:-1]
            try:
                return full(self, x)
            finally:
                self.blocks = blocks

        return forward

    return _patched(ViT, "forward", make)


def gelu_on_up():
    """SwiGLU's SiLU gate replaced by GELU on the up projection: a GELU MLP
    through ``fc1_x`` and ``fc2``, the gate's weights unread."""
    from naf_torch.backbones.vit import SwiGLU

    return _patched(SwiGLU, "forward", lambda full: lambda self, x: self.fc2(F.gelu(self.fc1_x(x))))


def rope_dropped_in_one_block():
    """The middle block's attention run without its RoPE."""
    from naf_torch.backbones.vit import Attention, ViT

    def make(full):
        def forward(self, x):
            attn = self.blocks[len(self.blocks) // 2].attn
            attn.forward = lambda y, rope=None, n_prefix=0: Attention.forward(attn, y, None,
                                                                             n_prefix)
            try:
                return full(self, x)
            finally:
                del attn.forward

        return forward

    return _patched(ViT, "forward", make)


def _flip_rows(out):
    out = out.clone()
    out[:, :2] = -out[:, :2]  # two rows of the answer (NHWC) flipped
    return out


def rows_flipped_upsampler():
    """Two rows of NAFUpsampler's answer flipped."""
    from naf_torch.api import NAFUpsampler

    return _patched(NAFUpsampler, "__call__",
                    lambda full: lambda self, *a, **k: _flip_rows(full(self, *a, **k)))


def rows_flipped_streamed():
    """Two rows of naf_streamed's answer flipped."""
    from naf_torch import api

    return _patched(api, "naf_streamed", lambda full: lambda *a, **k: _flip_rows(full(*a, **k)))


# each kind's faults, and the number each takes above its limit (the tests hold it so)
FAULTS = {
    "vfm_upsample": {"last_block_dropped": (last_block_dropped, "feat_rel_l2"),
                     "gelu_on_up": (gelu_on_up, "feat_rel_l2"),
                     "rope_dropped_in_one_block": (rope_dropped_in_one_block, "feat_rel_l2"),
                     "rows_flipped": (rows_flipped_upsampler, "max_err")},
    "streamed": {"rows_flipped": (rows_flipped_streamed, "max_err")},
}


def control(config, traffic, seed, device) -> dict:
    """The numbers of the reference in float8 against the float32 one, on
    the requests a run of ``seed`` checks."""
    from h100bench.kinds import streamed, vfm_upsample

    if traffic["kind"] == "vfm_upsample":
        prog = vfm_upsample.build(config, traffic, seed, device)
        prog.ups = None
        images = [prog.images[int(prog.order[c % len(prog.order)])] for c in prog.checked]
        return vfm_upsample.numbers(
            (vfm_upsample.reference(config, prog, im, q8=check.fp8),
             vfm_upsample.reference(config, prog, im)) for im in images)
    prog = streamed.Program(config, traffic, seed, device)
    prog.model = None
    rel = mx = 0.0
    for c in prog.checked:
        j = int(prog.order[c % len(prog.order)])
        rows = traffic["reference_rows"]
        r, m = streamed.block_numbers(
            (a, b) for (_, a), (_, b) in zip(
                streamed.reference_rows(config, prog, j, rows, q8=check.fp8),
                streamed.reference_rows(config, prog, j, rows)))
        rel, mx = max(rel, r), max(mx, m)
    return {"rel_l2": rel, "max_err": mx}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench.calibrate_large")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_large: no CUDA card", file=sys.stderr)
        return 3
    cell, config, traffic, _ = load_cell(args.workload)
    if traffic["kind"] not in FAULTS:
        print(f"calibrate_large: {cell['name']} is of kind {traffic['kind']!r}; "
              "use h100bench.calibrate", file=sys.stderr)
        return 2
    from naf_torch.kernels import _build

    _build.build()
    torch.backends.cudnn.allow_tf32 = config["tf32"]["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]["matmul"]
    dev = torch.device("cuda")
    faults = FAULTS[traffic["kind"]]
    readings = []

    def record(what, seed, fn):
        t0 = time.time()
        nums = fn()
        rec = {"cell": cell["name"], "what": what, "seed": seed, "numbers": nums,
               "s": time.time() - t0}
        readings.append(rec)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()

    def faulty(fault, seed):
        with faults[fault][0]():
            return _program(cell, config, traffic, seed, dev)

    for s in args.seeds:
        record("program", s, lambda: _program(cell, config, traffic, s, dev))
    for s in args.control_seeds:
        record("control", s, lambda: control(config, traffic, s, dev))
    for fault in faults:
        for s in args.faults:
            record(fault, s, lambda: faulty(fault, s))
    summary = {}
    for what in ("program", "control", *faults):
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
