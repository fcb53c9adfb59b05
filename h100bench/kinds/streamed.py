"""Closed-loop streamed upsampling: one caller that waits for each output
above 2K, written in bands of rows (batch 1 per call).

The traffic file is ``upsample``'s (``batch``, ``image``, ``features``,
``output``, ``distinct_inputs``, ``checked_calls``) with ``band_rows``, the
output rows a band, and ``reference_rows``, the rows of a block of the
reference. The program is ``naf_torch.api.naf_streamed(model, image,
lr_feats, output, band_rows=band_rows)`` on NHWC tensors resident on the
card, ``stream_encoder`` at its default; its output stays there. The model,
weights and requests are ``upsample.build``'s; the calls are timed and
checked as ``closed_loop`` times and checks them.

Numbers: ``rel_l2`` and ``max_err`` of the whole output against the
reference's (``reference/naf_rows.py``: ``reference/naf.py``'s NAF in blocks
of rows, whose float32 whole would not fit beside the program's output),
summed over the blocks, the worst over the checked calls.
"""

from __future__ import annotations

import gc
import time

import torch

from h100bench import closed_loop
from h100bench.kinds import upsample
from h100bench.reference import naf as ref_naf
from h100bench.reference.naf_rows import naf_rows

__all__ = ["Program", "reference_rows", "block_numbers", "numbers", "run"]


class Program:
    """``upsample.build``'s model, weights and requests, NHWC."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        up = upsample.build(config, traffic, seed, device)
        self.model, self.state = up.ups.model, up.state
        self.images = [i.permute(0, 2, 3, 1).contiguous() for i in up.images]
        self.feats = [f.permute(0, 2, 3, 1).contiguous() for f in up.feats]
        self.order, self.checked, self.out_hw = up.order, up.checked, up.out_hw
        self.band_rows = traffic["band_rows"]

    def __call__(self, j: int):
        from naf_torch import api

        return (api.naf_streamed(self.model, self.images[j], self.feats[j], self.out_hw,
                                 band_rows=self.band_rows),)


@torch.no_grad()
def reference_rows(config: dict, prog: Program, j: int, block_rows: int, q8=None):
    """Yield (r0, block) of the reference's output for request ``j``, f32
    NHWC (TF32 off while each block is computed)."""
    kw = {} if q8 is None else {"q8": q8}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield from naf_rows(ref_naf.naf_params(prog.state), config["model"],
                            prog.images[j].float(), prog.feats[j].float(), prog.out_hw,
                            block_rows, **kw)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _sums(out, ref, n: int = 1 << 26):
    """(sum (out - ref)^2, sum ref^2, max |out - ref|, max |ref|), float64,
    a chunk at a time."""
    a, b = out.reshape(-1), ref.reshape(-1)
    num = den = err = top = 0.0
    for i in range(0, a.numel(), n):
        x, y = a[i:i + n].double(), b[i:i + n].double()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
        err = max(err, float((x - y).abs().max()))
        top = max(top, float(y.abs().max()))
    return num, den, err, top


def block_numbers(blocks) -> tuple:
    """(rel_l2, max_err) of one output over its (block, reference block)
    pairs: the squares and maxima summed over all blocks."""
    num = den = err = top = 0.0
    for out, ref in blocks:
        s = _sums(out, ref)
        num, den, err, top = num + s[0], den + s[1], max(err, s[2]), max(top, s[3])
    return (num / den) ** 0.5, err / top


def numbers(pairs) -> dict:
    """``upsample.numbers`` of (output, reference blocks) pairs: each
    output's ``rel_l2`` and ``max_err`` over all its blocks, the worst over
    the pairs."""
    rel = mx = 0.0
    for out, blocks in pairs:
        r, m = block_numbers((out[:, r0:r0 + ref.shape[1]], ref) for r0, ref in blocks)
        rel, mx = max(rel, r), max(mx, m)
    return {"rel_l2": rel, "max_err": mx}


def run(config, traffic, seed, seconds, traced, device, t_start) -> dict:
    dev = torch.device(device)
    prog = Program(config, traffic, seed, dev)
    loop = closed_loop.closed_loop(prog, prog.order, prog.checked, seconds, traced, dev, t_start)
    served = loop.pop("served")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rows = traffic["reference_rows"]
    t0 = time.perf_counter()
    nums = numbers((outs[0], reference_rows(config, prog, int(prog.order[c % len(prog.order)]),
                                            rows)) for outs, c in served)
    ref_s = time.perf_counter() - t0
    return closed_loop.result(loop, nums, traffic["batch"], dev, traced,
                              upsample.work_per_call(config, traffic),
                              [f"reference and comparison: {ref_s!r} s for {len(served)} calls"])
