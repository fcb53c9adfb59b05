"""The headline bench (counterpart of the root ``bench.py`` and its probes
``tools/north_star.py``, ``tools/northstar_decomp.py``,
``tools/stage_profile.py`` and ``tools/measure_mem.py``):

    python -m naf_torch.bench.headline                 # every field, on the card
    python -m naf_torch.bench.headline --only fps_448to2048_r16
    python -m naf_torch.bench.headline --stages [OUT]  # 448^2 + 128^2 x 384 -> OUT^2 by stage
    python -m naf_torch.bench.headline --device cpu    # the plain path, at full size: slow

NAF at ``load_naf_params``' defaults (dim 256, k 9) with the weights of seed
0, in bf16, batch 1. Every input is drawn from one
``np.random.RandomState(0)`` in ``bench.py``'s order (:func:`headline_inputs`),
so both packages time the same tensors. The fields (``bench.py:56-165``):

- ``naf_fwd_fps_448_r16_dim384`` (the line's ``value``): 448^2 + 28^2 x 384
  -> 448^2, ``NAF.forward``; ``vs_baseline`` is its fps over the A100's
  1000 / 56.24;
- ``bwd_ms_448_r16``: the same shape's step of the reference's backward
  benchmark (a 1x1 head, mean of squares, SGD 1e-3 on the parameters and
  the head: ``naf_torch.bench.harness._train_step``), on a copy of the model,
  so that the later fields time the seeded weights;
- ``fps_2048_r16``: 2048^2 + 128^2 x 384 -> 2048^2;
- ``fps_448to2048_r16``: 448^2 + 128^2 x 384 -> 2048^2;
- ``na_kernel_ms_448``: the bare ``cross_scale_na2d_fused`` (K3), q (1, 448,
  448, 4, 64) against 28^2 keys, dv 96, k 9; its host planning is part of
  the call, and its tables are cached across calls (``functools.lru_cache``
  on ``na2d_fused._plan_tc``);
- ``fps_4096``: ``naf_streamed`` 512^2 + 256^2 x 384 -> 4096^2,
  ``band_rows=512``: wall time around one call bracketed by
  ``torch.cuda.synchronize``, after one warm-up call, the median of
  ``repeats`` calls.

The other fields are timed by ``device_time_stats``: CUDA events around
back-to-back calls after warm-up, the median of ``repeats`` samples, the
host's gaps between launches included (what a caller sees). ``bench.py``'s
chained scan with a data-dependent epsilon keeps XLA from folding or
hoisting the timed work; eager torch does neither, so it has no counterpart.
Each field also makes one more call, which gives its launches per kernel
(``naf_torch.kernels.launch_counts``) and its peak: ``max_memory_allocated``
less what was allocated before the call, the semantics of the reference's
memory benchmark (``tools/measure_mem.py`` bisects a TPU's memory with
fillers because its tunnel returns no memory statistics; that has no
counterpart). cuDNN's and cuBLAS's TF32 stay off unless ``--tf32``.

``main`` prints the full record (each field's median, min and max ms, its
launches, its peak, ``tf32`` and the card's name and power limit) on one
line, then last a line with exactly ``bench.py``'s keys. A field that fails
raises and the command exits non-zero, where ``bench.py`` records
``fps_4096_error``. ``--only FIELD`` runs one field (``tools/north_star.py``);
``--stages [OUT]`` times the forward by stage in one process
(``tools/northstar_decomp.py``: a bf16 8192^3 matmul canary, then ``model``,
``encoder``, ``pre_attn``, ``fused_q`` and ``glue_residual``).

Runs on the card by default and raises without CUDA; ``device="cpu"``
runs the plain path (the tests pass smaller ``sizes``, a dict with
:data:`HEADLINE`'s keys).
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import time

import numpy as np
import torch

from naf_torch.api import _device, load_naf_params, naf_streamed
from naf_torch.bench.harness import _device_name, _free, _peak_call, _train_step
from naf_torch.kernels import launch_counts
from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
from naf_torch.utils.benchmarking import card_line, device_time_stats, tf32 as _tf32

__all__ = ["HEADLINE", "FIELDS", "STAGE_LAUNCHES", "headline_inputs", "expected_launches",
           "check_launches", "run", "stages", "bench_line", "main"]

# bench.py's shapes (NHWC; q, k, v as (B, H, W, heads, d))
HEADLINE = {
    "image": (1, 448, 448, 3),
    "feats": (1, 28, 28, 384),
    "image2": (1, 2048, 2048, 3),
    "feats2": (1, 128, 128, 384),
    "q": (1, 448, 448, 4, 64),
    "k": (1, 28, 28, 4, 64),
    "v": (1, 28, 28, 4, 96),
    "kernel": 9,
    "img512": (1, 512, 512, 3),
    "feats4k": (1, 256, 256, 384),
    "out": 448,
    "out2": 2048,
    "out4k": 4096,
    "band_rows": 512,
    "naf": {},  # NAF's hyperparameters: load_naf_params' defaults (dim 256, k 9)
    "a100_ms": 56.24,  # the reference's A100 40GB forward, test_results.json:243-256
    "canary": 8192,  # --stages' bf16 matmul side
}

# bench.py's calls per sample (its scan lengths): 15 at 448^2, 6 at 2048^2
ITERS = {"naf_fwd_fps_448_r16_dim384": 15, "bwd_ms_448_r16": 15, "fps_2048_r16": 6,
         "fps_448to2048_r16": 6, "na_kernel_ms_448": 15}
STAGE_ITERS = 6
DTYPE = torch.bfloat16


def headline_inputs(sizes=None, device="cuda", dtype=DTYPE, names=None) -> dict:
    """Every input, drawn from one ``np.random.RandomState(0)`` in
    ``bench.py``'s order (image, feats, head x 0.01, image2, feats2, q, k, v,
    img512, feats4k) and cast to ``dtype`` on ``device``; with ``names``,
    only those, the draws stopping after the last of them."""
    sizes = sizes or HEADLINE
    rng = np.random.RandomState(0)
    c = sizes["feats"][-1]
    shapes = [("image", sizes["image"]), ("feats", sizes["feats"]), ("head", (c, c)),
              ("image2", sizes["image2"]), ("feats2", sizes["feats2"]), ("q", sizes["q"]),
              ("k", sizes["k"]), ("v", sizes["v"]), ("img512", sizes["img512"]),
              ("feats4k", sizes["feats4k"])]
    names = [n for n, _ in shapes] if names is None else names
    last = max(i for i, (n, _) in enumerate(shapes) if n in names)
    out = {}
    for name, shape in shapes[: last + 1]:
        x = rng.randn(*shape)
        if name == "head":
            x = x * 0.01
        if name in names:
            out[name] = torch.from_numpy(x).to(device, dtype)
    return out


def expected_launches(sizes=None) -> dict:
    """The launches one call of each field makes on the card: 8 K1 for the
    two encoder stacks, 1 K2 per forward (one per band of ``fps_4096``), and
    the step's K2 gradient on 1 K3 and 1 K4 (one band of partials at 448^2)."""
    sizes, fwd = sizes or HEADLINE, {"k1": 8, "k2": 1}
    return {"naf_fwd_fps_448_r16_dim384": fwd,
            "bwd_ms_448_r16": {**fwd, "k3": 1, "k4": 1},
            "fps_2048_r16": fwd, "fps_448to2048_r16": fwd,
            "na_kernel_ms_448": {"k3": 1},
            "fps_4096": {"k1": 8, "k2": sizes["out4k"] // sizes["band_rows"]}}


# the launches one call of each stage makes on the card
STAGE_LAUNCHES = {"model": {"k1": 8, "k2": 1}, "encoder": {"k1": 8}, "pre_attn": {"k1": 8},
                  "fused_q": {"k2": 1}}


def check_launches(label: str, launches: dict, want: dict) -> None:
    """Raises unless one call's ``launches`` (kernels and routes, as the
    record gives them) hold exactly ``want`` of K1-K4, with bf16 K2 and
    K3/K4 on the tensor-core route."""
    got = {k: v for k, v in launches.items() if k in ("k1", "k2", "k3", "k4")}
    routes = (launches.get("k2_wgmma", 0), launches.get("k34_wgmma", 0),
              launches.get("k34_wgmma_bwd", 0))
    if got != want or routes != (got.get("k2", 0), got.get("k3", 0), got.get("k4", 0)):
        raise AssertionError(f"headline {label}: a call launched {launches}, want {want} on "
                             "the wgmma route")


def _counts() -> dict:
    return {**launch_counts(),
            **{f"k2_{r}": n for r, n in naf_upsample_attention.route_launches.items()},
            **{f"k34_{r}": n for r, n in cross_scale_na2d_fused.route_launches.items()}}


def _counted_call(fn, dev: torch.device):
    """One call of ``fn``: its output, the launches it made (kernels and
    routes with a launch) and its peak MiB above what was allocated before
    it (None off the card)."""
    before = _counts()
    out, peak = _peak_call(fn, dev)
    launches = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    return out, launches, peak


def _check_finite(name: str, out: torch.Tensor) -> None:
    """Raises unless every element of ``out`` is finite (a chunk at a time:
    a 4096^2 x 384 output's mask would take 6 GB at once)."""
    flat, chunk = out.detach().reshape(-1), 1 << 26
    for i in range(0, flat.numel(), chunk):
        if not bool(torch.isfinite(flat[i : i + chunk]).all()):
            raise FloatingPointError(f"{name}: the output holds a non-finite value")


def _timer(dev: torch.device) -> str:
    return "cuda events" if dev.type == "cuda" else "perf_counter (cpu)"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Run:
    """The model, inputs and timer settings that the fields share."""

    def __init__(self, sizes, dev, iters, repeats, warmup, names=None):
        self.sizes, self.dev = sizes, dev
        self.iters, self.repeats, self.warmup = iters, repeats, warmup
        self.model = load_naf_params(seed=0, device=dev, dtype=DTYPE, **sizes["naf"])
        self.x = headline_inputs(sizes, dev, names=names)

    def timed(self, name: str, fn, fps: bool = True) -> dict:
        """``fn`` timed by ``device_time_stats``, then one counted call."""
        iters = self.iters or ITERS[name]
        stats = device_time_stats(fn, iters=iters, repeats=self.repeats, warmup=self.warmup,
                                  device=self.dev)
        out, launches, peak = _counted_call(fn, self.dev)
        _check_finite(name, out)
        del out
        return _result(stats["median"], stats["min"], stats["max"], fps, launches, peak,
                       timing=f"{_timer(self.dev)}, {self.repeats} samples of {iters} calls "
                              f"after {self.warmup} warm-up calls")


def _result(ms, ms_min, ms_max, fps, launches, peak, **extra) -> dict:
    res = {"ms": ms, "ms_min": ms_min, "ms_max": ms_max, "launches": launches,
           "peak_mib": peak, **extra}
    res["value"] = 1e3 / ms if fps else ms
    return res


def _forward(model, image, feats, size):
    with torch.no_grad():
        return model(image, feats, size)


def _fps_448(r: _Run) -> dict:
    x, s = r.x, (r.sizes["out"],) * 2
    return r.timed("naf_fwd_fps_448_r16_dim384",
                   lambda: _forward(r.model, x["image"], x["feats"], s))


def _bwd_448(r: _Run) -> dict:
    """The step updates its weights in place, as JAX's does: it runs on a
    copy of the model and the head."""
    x, s = r.x, (r.sizes["out"],) * 2
    model, head = copy.deepcopy(r.model), x["head"].clone().requires_grad_()
    res = r.timed("bwd_ms_448_r16",
                  lambda: _train_step(model, head, x["image"], x["feats"], s), fps=False)
    del model, head
    return res


def _fps_2048(r: _Run) -> dict:
    x, s = r.x, (r.sizes["out2"],) * 2
    return r.timed("fps_2048_r16", lambda: _forward(r.model, x["image2"], x["feats2"], s))


def _fps_448to2048(r: _Run) -> dict:
    x, s = r.x, (r.sizes["out2"],) * 2
    return r.timed("fps_448to2048_r16", lambda: _forward(r.model, x["image"], x["feats2"], s))


def _na_kernel(r: _Run) -> dict:
    x, ks = r.x, r.sizes["kernel"]
    res = r.timed("na_kernel_ms_448",
                  lambda: cross_scale_na2d_fused(x["q"], x["k"], x["v"], ks), fps=False)
    res["tables"] = "cached across calls (functools.lru_cache on na2d_fused._plan_tc)"
    return res


def _fps_4096(r: _Run) -> dict:
    """Wall time around one call, bracketed by synchronizes, after one
    warm-up call; the median of ``repeats`` calls (``bench.py:119-145``)."""
    x, s = r.x, (r.sizes["out4k"],) * 2

    def call():
        return naf_streamed(r.model, x["img512"], x["feats4k"], s,
                            band_rows=r.sizes["band_rows"])

    out, launches, peak = _counted_call(call, r.dev)  # the warm-up call
    _check_finite("fps_4096", out)
    del out
    walls = []
    for _ in range(r.repeats):
        _sync(r.dev)
        t0 = time.perf_counter()
        out = call()
        _sync(r.dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        del out
    return _result(statistics.median(walls), min(walls), max(walls), True, launches, peak,
                   timing=f"wall time around one call, {r.repeats} calls after one warm-up "
                          "call")


# bench.py's fields in its order, by the name its line gives each
FIELDS = {"naf_fwd_fps_448_r16_dim384": _fps_448, "bwd_ms_448_r16": _bwd_448,
          "fps_2048_r16": _fps_2048, "fps_448to2048_r16": _fps_448to2048,
          "na_kernel_ms_448": _na_kernel, "fps_4096": _fps_4096}


def _header(dev: torch.device, tf32: bool, sizes: dict) -> dict:
    return {"device": _device_name(dev), "card": card_line() if dev.type == "cuda" else "cpu",
            "dtype": str(DTYPE).removeprefix("torch."), "tf32": tf32,
            "sizes": sizes}


def run(device="cuda", sizes=None, only=None, iters=None, repeats: int = 3,
        warmup: int = 3, tf32: bool = False) -> dict:
    """The fields of ``FIELDS`` (or the one named ``only``) in ``bench.py``'s
    order, with TF32 as ``tf32`` says: the record ``main`` prints. ``iters``
    (calls per sample) defaults to ``bench.py``'s per field."""
    dev, sizes = _device(device), sizes or HEADLINE
    names = list(FIELDS) if only is None else [only]
    if any(n not in FIELDS for n in names):
        raise ValueError(f"no field {only!r}; the fields are {list(FIELDS)}")
    with _tf32(tf32):
        r = _Run(sizes, dev, iters, repeats, warmup)
        fields = {}
        for name in names:
            fields[name] = FIELDS[name](r)
            _free(dev)
    rec = {**_header(dev, tf32, sizes), "fields": fields}
    if "bwd_ms_448_r16" in fields and "naf_fwd_fps_448_r16_dim384" in fields:
        rec["peak_mib_448"] = {"forward": fields["naf_fwd_fps_448_r16_dim384"]["peak_mib"],
                               "backward": fields["bwd_ms_448_r16"]["peak_mib"]}
    return rec


def bench_line(rec: dict) -> dict:
    """``bench.py``'s line, with exactly its keys and roundings, from a
    record of every field."""
    f = {name: res["value"] for name, res in rec["fields"].items()}
    fps = f["naf_fwd_fps_448_r16_dim384"]
    ref_fps = 1000.0 / rec["sizes"]["a100_ms"]
    return {
        "metric": "naf_fwd_fps_448_r16_dim384",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / ref_fps, 2),
        "fps_2048_r16": round(f["fps_2048_r16"], 2),
        "fps_448to2048_r16": round(f["fps_448to2048_r16"], 2),
        "bwd_ms_448_r16": round(f["bwd_ms_448_r16"], 2),
        "na_kernel_ms_448": round(f["na_kernel_ms_448"], 3),
        "device": rec["device"],
        "dtype": rec["dtype"],
        "fps_4096": round(f["fps_4096"], 3),
    }


def stages(out=None, device="cuda", sizes=None, iters: int = STAGE_ITERS,
           repeats: int = 3, warmup: int = 3, tf32: bool = False) -> dict:
    """``tools/northstar_decomp.py`` in one process: a bf16 matmul canary,
    then the forward at image + feats2 -> ``out``^2 (default ``out2``) and
    its stages: ``model`` (``NAF.forward``), ``encoder``
    (``encode_guarded``), ``pre_attn`` (``NAF._fused_q_inputs``: the encoder,
    the pooled keys and the RoPE tables), ``fused_q`` (K2 on those inputs,
    computed once beforehand) and ``glue_residual`` = model - pre_attn -
    fused_q. Each stage's median ms in ``stages_ms``, its spread and
    launches in ``detail``."""
    dev, sizes = _device(device), sizes or HEADLINE
    size = (int(out or sizes["out2"]),) * 2
    timer = dict(iters=iters, repeats=repeats, warmup=warmup, device=dev)
    with _tf32(tf32):
        r = _Run(sizes, dev, iters, repeats, warmup, names=("image", "feats2"))
        model, image, feats = r.model, r.x["image"], r.x["feats2"]
        a = torch.ones(sizes["canary"], sizes["canary"], dtype=DTYPE, device=dev)
        canary = device_time_stats(torch.matmul, a, a, **timer)
        del a
        enc = model.image_encoder
        with torch.no_grad():
            inputs = model._fused_q_inputs(image, feats, size)
        d_head = enc.rope.d_head
        fns = {
            "model": lambda: model(image, feats, size),
            "encoder": lambda: enc.encode_guarded(image, size),
            "pre_attn": lambda: model._fused_q_inputs(image, feats, size),
            "fused_q": lambda: naf_upsample_attention(
                *inputs[:2], feats, *inputs[2:], d_head, num_heads=model.heads_attn,
                kernel_size=model.kernel_size),
        }
        detail = {}
        with torch.no_grad():
            for name, fn in fns.items():
                st = device_time_stats(fn, **timer)
                _, launches, peak = _counted_call(fn, dev)
                detail[name] = _result(st["median"], st["min"], st["max"], False, launches,
                                       peak)
                _free(dev)
    ms = {k: v["ms"] for k, v in detail.items()}
    ms["glue_residual"] = ms["model"] - ms["pre_attn"] - ms["fused_q"]
    return {**_header(dev, tf32, sizes), "out": size[0], "canary_ms": canary["median"],
            "canary": f"bf16 {sizes['canary']}^3 matmul", "stages_ms": ms,
            "fps": 1e3 / ms["model"], "detail": detail,
            "timing": f"{_timer(dev)}, {repeats} samples of {iters} calls after {warmup} "
                      "warm-up calls"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m naf_torch.bench.headline",
                                 description="bench.py's headline line, on the port")
    ap.add_argument("--only", nargs="?", const="fps_448to2048_r16", choices=list(FIELDS),
                    help="one field (default fps_448to2048_r16), as tools/north_star.py")
    ap.add_argument("--stages", nargs="?", type=int, const=0, metavar="OUT",
                    help="the 448^2 + 128^2 x 384 -> OUT^2 forward by stage (default 2048)")
    ap.add_argument("--tf32", action="store_true",
                    help="let cuDNN and cuBLAS run f32 convs and matmuls on TF32 (default: off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    if args.stages is not None:
        rec = stages(args.stages or None, device=args.device, tf32=args.tf32)
        print(json.dumps(rec), flush=True)
        print("canary {canary_ms:.3f} ms; ".format(**rec) + ", ".join(
            f"{k} {v:.3f} ms" for k, v in rec["stages_ms"].items()), flush=True)
        return 0
    rec = run(device=args.device, only=args.only, tf32=args.tf32)
    print(json.dumps(rec), flush=True)
    if args.only is not None:
        res = rec["fields"][args.only]
        print(f"{args.only} = {res['value']:.2f}  ({res['ms']:.2f} ms)", flush=True)
        return 0
    print(json.dumps(bench_line(rec)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
