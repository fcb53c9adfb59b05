"""Where the f32 spatially sharded train step's gradient parts from the
one-process step's: the encoder convs' weight gradients, summed by cuDNN
over other partitions of the pixels.

    python naf_torch/tools/wgrad_partition.py

It takes ``chip_smoke.py``'s phase-17 case ``448_f32`` (the production NAF
from seed 0, 448^2 + 28^2 x 384 -> 448^2, its image, features and target)
at one step, TF32 off, and prints, with the card's name and power limit:

1. the spatial step on two gloo ranks sharing the card (data 1, space 2)
   against the one-process step that rank 0 takes beside it, and that
   one-process step against the same step taken again in this process (the
   run-to-run spread): the first-step gradients' rel norm over all
   parameters, as phase 17 reads it, and per parameter tensor for the
   encoder convs;
2. for each encoder conv of this process's backward (the plain twin's
   ``F.conv2d``, its input and its output's gradient captured), cuDNN's
   weight and bias gradient (``aten.convolution_backward``, as autograd
   calls it) over the whole grid, over the two halves of the rows, each
   with the conv's halo, summed, and in float64 on the same activations;
   their rel differences per conv, and summed over every conv as a share of
   the whole gradient's norm: what the partition alone gives phase 17's
   metric, and how far either f32 sum lies from the exact one.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _capture(ef):
    """Wrap ``encoder_fused._conv_nhwc`` so that every call made under
    autograd records its input, weight, bias and, once the backward reaches
    it, its output's gradient; returns the records and the undo."""
    orig, records = ef._conv_nhwc, []

    def conv(x, weight, bias=None):
        y = orig(x, weight, bias)
        if y.requires_grad:
            rec = {"x": x.detach(), "weight": weight.detach(),
                   "bias": None if bias is None else bias.detach()}
            y.register_hook(lambda g, rec=rec: rec.__setitem__("dy", g.detach()))
            records.append(rec)
        return y

    ef._conv_nhwc = conv
    return records, lambda: setattr(ef, "_conv_nhwc", orig)


def _conv_grads(xp, dy, weight, has_bias: bool, dtype):
    import torch

    w = weight.to(dtype)
    _, gw, gb = torch.ops.aten.convolution_backward(
        dy.to(dtype), xp.to(dtype), w, [w.shape[0]] if has_bias else None, [1, 1], [0, 0],
        [1, 1], False, [0, 0], 1, [False, True, has_bias])
    return torch.cat([gw.flatten(), gb]) if has_bias else gw.flatten()


def _partition(rec):
    """cuDNN's weight (and bias) gradient of one captured conv: the whole
    grid, the two row halves each with the conv's halo summed, float64."""
    import torch
    import torch.nn.functional as F

    p = rec["weight"].shape[-1] // 2
    xp = rec["x"].permute(0, 3, 1, 2).float()
    if p:
        xp = F.pad(xp, (p, p, p, p), mode="reflect")
    dy = rec["dy"].permute(0, 3, 1, 2).float()
    has_bias, w = rec["bias"] is not None, rec["weight"]
    m = dy.shape[2] // 2
    whole = _conv_grads(xp, dy, w, has_bias, torch.float32)
    halves = (_conv_grads(xp[:, :, : m + 2 * p], dy[:, :, :m], w, has_bias, torch.float32)
              + _conv_grads(xp[:, :, m:], dy[:, :, m:], w, has_bias, torch.float32))
    exact = _conv_grads(xp, dy, w, has_bias, torch.float64)
    return whole, halves, exact


def main() -> int:
    import torch
    from torch.func import functional_call

    sys.path.insert(0, str(ROOT))
    spec_ = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    from naf_torch.dryrun import _model, each
    from naf_torch.kernels import _build
    from naf_torch.kernels import encoder_fused as ef
    from naf_torch.parallel import run_ranks
    from naf_torch.utils.benchmarking import card_line
    from naf_torch.utils.spans import to_device

    if not torch.cuda.is_available():
        raise SystemExit("wgrad_partition needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    _build.build()
    case, spec = smoke._spatial_train_calls(smoke.PARALLEL_RANKS)[
        list(smoke.SPATIAL_TRAIN).index("448_f32")]
    spec = dict(spec, steps=1)
    ranks = run_ranks(each, smoke.PARALLEL_RANKS, args=([(case, spec)],), device="cuda")
    spatial, single = ranks[0][0]["spatial"]["grads"], ranks[0][0]["single"]["grads"]

    # this process: the one-process step's gradient, the encoder convs captured
    dev = torch.device("cuda", 0)
    model = _model(spec, dev, torch.float32).train()
    image, feats = (to_device(spec[k], dev) for k in ("image", "feats"))
    gen = torch.Generator(device=dev).manual_seed(spec["target_seed"])
    target = torch.randn(tuple(spec["target_shape"]), generator=gen, device=dev)
    records, undo = _capture(ef)
    try:
        pred = functional_call(model, dict(model.named_parameters()),
                               (image, feats, tuple(spec["out_hw"])))
        (pred - target).square().mean().backward()
    finally:
        undo()
    again = {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()}
    names = list(single)
    flat = lambda g: torch.cat([g[k].flatten() for k in names])  # noqa: E731
    card = card_line()
    print(f"wgrad_partition: first-step gradients over all {len(names)} parameter tensors, "
          f"rel norm: spatial step (2 ranks) vs one process {_rel(flat(spatial), flat(single)):.3e}"
          f"; one process vs one process again {_rel(flat(again), flat(single)):.3e} ({card})",
          flush=True)

    by_ptr = {p.data_ptr(): k for k, p in model.named_parameters()}
    norm = flat(single).double().norm()
    sums = {"halves": 0.0, "whole_f64": 0.0, "halves_f64": 0.0, "spatial": 0.0}
    for rec in records:
        name = by_ptr[rec["weight"].data_ptr()]
        whole, halves, exact = _partition(rec)
        keys = [name] + ([name[: -len("weight")] + "bias"] if rec["bias"] is not None else [])
        sp = torch.cat([spatial[k].flatten() for k in keys]).to(whole.device)
        one = torch.cat([single[k].flatten() for k in keys]).to(whole.device)
        parts = {"halves": halves - whole, "whole_f64": whole.double() - exact,
                 "halves_f64": halves.double() - exact, "spatial": sp - one}
        for k, d in parts.items():
            sums[k] += float(d.double().norm()) ** 2
        print(f"wgrad_partition: {' + '.join(keys)} {tuple(rec['weight'].shape)} rel: halves vs "
              f"whole {_rel(halves, whole):.3e}, whole vs f64 {_rel(whole, exact):.3e}, halves "
              f"vs f64 {_rel(halves, exact):.3e}; spatial step vs one process "
              f"{_rel(sp, one):.3e}", flush=True)
    print("wgrad_partition: over the encoder convs, as a share of the whole gradient's norm: "
          + ", ".join(f"{k} {v ** 0.5 / float(norm):.3e}" for k, v in sums.items())
          + f" ({len(records)} convs; {card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
