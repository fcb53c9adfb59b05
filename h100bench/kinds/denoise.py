"""The denoiser's training step (NAF trained as a restorer), driven as
``train_denoiser``'s device-stack route drives it: ``make_denoise_chunk``
over ``make_denoise_step``, ``chunk_steps`` steps a call on batches gathered
on the card from a resident stack of seeded clean images, each step's noise
drawn by the program from ``step_generator(seed, step)``.

Set-up builds one training object (NAF's f32 masters, AdamW, the loss) and
drives it from the seed through its first ``checked_steps`` steps, a chunk
of one step each, on rows that all differ; it keeps each step's loss, the
first gradient as AdamW holds it, the masters after the last
(``distill.Program.first_steps``) and each step's prediction (a forward
hook on the model, removed before the window). The same object then trains
through the window in whole chunks; a traced run profiles one chunk more,
after the window. After the window the reference (``reference/denoise.py``)
takes those steps from the same weights, on the same clean and noisy
batches. The numbers compared (:func:`numbers`) are the distillation
kind's three (``distill.numbers``) and four of the restorer's own:

- ``pred_rel_l2``: the first step's prediction against the reference's,
  from the same weights: what the working precision moves;
- ``loss_fn_gap``: each step's loss against the reference's loss of the
  program's own prediction, the worst step's relative gap: what the loss
  layer computes, whatever the model's precision;
- ``grad_rel_l2``: the first gradient against the reference's, all leaves
  as one vector: a backward that misses part of the batch, where the
  reported loss is whole;
- ``noise_z``: the checked steps' noise (noisy - clean) against the
  configuration's gaussian, its mean against 0 and its root mean square
  against sigma, in standard errors of the sample (the worst of both over
  the steps): the noise the program drew, which both sides then share.

The resident stack's images differ in their statistics (:func:`images`),
so that the images of a batch pull the weights different ways.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from h100bench import check, trace, work, work_na
from h100bench.kinds import distill
from h100bench.reference.denoise import denoise_loss, denoise_steps
from h100bench.weights import draw, generator, naf_specs, subseed

__all__ = ["Program", "images", "checked_batches", "grad_rel_l2", "noise_z", "numbers",
           "control_numbers", "run", "work_per_step"]


def images(gen: torch.Generator, n: int, size: int) -> torch.Tensor:
    """``n`` clean (size, size, 3) f32 images in [0, 1] on ``gen``'s device,
    each of its own statistics: uniform noise on a grid of 2 to ``size``
    cells a side (log-uniform), three colours mixed toward their grey by a
    uniform share, upsampled to ``size`` by nearest cells or bilinearly
    (even odds), stretched to [0, 1], then scaled to a contrast uniform in
    [0.05, 1] about a mean that keeps it inside [0, 1]."""
    out = torch.empty(n, size, size, 3, device=gen.device)
    for i in range(n):
        side_u, contrast_u, mean_u, mode_u, colour_u = torch.rand(
            5, generator=gen, device=gen.device).tolist()
        side = int(round(2 ** (1 + side_u * (math.log2(size) - 1))))
        t = torch.rand(1, 3, side, side, generator=gen, device=gen.device)
        t = colour_u * t + (1 - colour_u) * t.mean(1, keepdim=True)
        if mode_u < 0.5:
            t = F.interpolate(t, size=(size, size), mode="nearest")
        else:
            t = F.interpolate(t, size=(size, size), mode="bilinear", align_corners=False)
        t = (t - t.amin()) / (t.amax() - t.amin()).clamp_min(1e-12)
        contrast = 0.05 + 0.95 * contrast_u
        mean = contrast / 2 + mean_u * (1 - contrast)
        out[i] = (mean + contrast * (t[0] - 0.5)).permute(1, 2, 0)
    return out


class Program:
    def __init__(self, config, traffic, seed, device):
        from naf_torch.evals.denoising import DenoisingLoss, NoiseGenerator
        from naf_torch.models.naf import NAF
        from naf_torch.train.denoise import (
            DenoiseConfig, make_denoise_chunk, make_denoise_step, make_optimizer,
        )

        tr, den = config["train"], config["denoising"]
        self.config = config
        self.noise_seed = subseed(seed, "noise")
        self.naf_init = draw(naf_specs(config["model"]), generator(seed, "weights", device),
                             torch.float32)
        with torch.device(device):
            model = NAF(**config["model"])
        missing, unexpected = model.load_state_dict(self.naf_init, strict=False)
        if unexpected or set(missing) != {"image_encoder.rope.periods"}:
            raise RuntimeError(f"NAF weights do not fit: {missing}, {unexpected}")
        self.model = model.to(device)
        size = config["img_size"]
        dcfg = DenoiseConfig(lr=tr["lr"], weight_decay=tr["weight_decay"],
                             noise_type=den["noise_type"], noise_params=den["noise_params"],
                             l1_weight=den["l1_weight"], l2_weight=den["l2_weight"],
                             ssim_weight=den["ssim_weight"], use_bf16=tr["use_bf16"])
        self.optimizer = make_optimizer(self.model, dcfg)
        self.noise = NoiseGenerator(dcfg.noise_type)
        step = make_denoise_step(self.model, self.optimizer,
                                 DenoisingLoss(dcfg.l1_weight, dcfg.l2_weight, dcfg.ssim_weight),
                                 self.noise, dcfg.noise_params, (size, size), dcfg.use_bf16)
        self.chunk = make_denoise_chunk(step, self.noise_seed)
        self.stack = images(generator(seed, "images", device), traffic["stack_images"], size)
        self.feed = distill._batches(np.random.default_rng(subseed(seed, "feed")),
                                     traffic["stack_images"], tr["batch_size"])
        self.steps = 0

    def run_chunk(self, k: int):
        """Launch ``k`` steps; returns the chunk's losses on the device."""
        idx = np.stack([next(self.feed) for _ in range(k)])
        losses = self.chunk(self.stack, idx, self.steps)
        self.steps += k
        return losses, idx

    def first_steps(self, n: int):
        """The checked steps, a chunk of one each: (losses, first gradient,
        masters after the last, the rows of each step, each step's
        prediction in f32, kept on the host so that the window's peak
        leaves it out)."""
        preds = []
        hook = self.model.register_forward_hook(
            lambda module, args, out: preds.append(out.detach().float().cpu()))
        try:
            return (*distill.Program.first_steps(self, n), preds)
        finally:
            hook.remove()

    def noisy(self, step: int, clean: torch.Tensor) -> torch.Tensor:
        """The noisy batch the program made of ``clean`` at ``step``."""
        from naf_torch.train.trainer import step_generator

        return self.noise(step_generator(self.noise_seed, step, clean.device), clean,
                          self.config["denoising"]["noise_params"])


def checked_batches(prog: Program, rows):
    """The clean and noisy batches of the first steps, taken on ``rows``."""
    cleans = [prog.stack.index_select(0, torch.as_tensor(r, device=prog.stack.device))
              for r in rows]
    return cleans, [prog.noisy(s, c) for s, c in enumerate(cleans)]


def grad_rel_l2(grad1: dict, ref_grad1: dict) -> float:
    """||g - g_ref|| / ||g_ref|| over every leaf as one vector, in float64."""
    num = sum(float((grad1[k].double() - r.double()).square().sum()) for k, r in ref_grad1.items())
    den = sum(float(r.double().square().sum()) for r in ref_grad1.values())
    return (num / den) ** 0.5


def noise_z(cleans, noisies, den: dict) -> float:
    """The worst, over the steps, of |mean| / sigma * sqrt(n) and
    |rms / sigma - 1| * sqrt(2 n) of the noise (noisy - clean, n values): a
    gaussian of mean 0 and std sigma reads each as the size of a standard
    normal draw."""
    if den["noise_type"] != "gaussian":
        raise ValueError(f"noise_z holds gaussian noise, not {den['noise_type']!r}")
    sigma = float(den["noise_params"]["std"])
    worst = 0.0
    for clean, noisy in zip(cleans, noisies):
        noise = noisy.double() - clean.double()
        n = noise.numel()
        mean, rms = float(noise.mean()), float(noise.square().mean()) ** 0.5
        worst = max(worst, abs(mean) / sigma * n ** 0.5, abs(rms / sigma - 1) * (2 * n) ** 0.5)
    return worst


def numbers(first, ref, naf_init, cleans, noisies, config: dict, kept=None) -> dict:
    """The numbers compared: ``first`` is the program's first steps
    (:meth:`Program.first_steps`), ``ref`` the reference's
    (``denoise_steps``), ``cleans`` and ``noisies`` the steps' clean and
    noisy batches; ``kept``, a dict, receives the worst leaves
    (``distill.numbers``)."""
    losses, grad1, params, preds = first[0], first[1], first[2], first[-1]
    nums = distill.numbers(losses, grad1, params, naf_init, ref[:3], kept)
    nums["pred_rel_l2"] = check.rel_l2(preds[0].to(ref[3].device), ref[3])
    own = [float(denoise_loss(p.to(c.device), c.float(), config["denoising"]))
           for p, c in zip(preds, cleans)]
    nums["loss_fn_gap"] = max(abs(a - b) / abs(b) for a, b in zip(losses, own))
    nums["grad_rel_l2"] = grad_rel_l2(grad1, ref[1])
    nums["noise_z"] = noise_z(cleans, noisies, config["denoising"])
    return nums


def work_per_step(config: dict) -> dict:
    """One step's kernel work and FLOPs: K1's forward layers, K2's forward,
    K3 and K4 in the backward, and NAF's forward and backward at 3x the
    forward's encoder convolutions and attention."""
    s, b, m = config["img_size"], config["train"]["batch_size"], config["model"]
    dim, heads, k, c = m["dim"], m["heads_attn"], m["kernel_size"], 3
    return {"k1": work.k1_work(b, s, s, dim, m["img_layers"]),
            "k2": work.k2_work(b, (s, s), (s, s), (s, s), dim, heads, k, c),
            "k34": work_na.k34_work(b, (s, s), (s, s), heads, k, dim // heads, c // heads),
            "flops": 3 * work.naf_forward_flops(b, (s, s), (s, s), m, c)}


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def control_numbers(config, traffic, seed, device) -> dict:
    """The control's numbers: the reference in float8 (``check.fp8``)
    against the float32 reference, on the program's first steps' batches."""
    prog = Program(config, traffic, seed, device)
    rows = [next(prog.feed) for _ in range(traffic["checked_steps"])]
    cleans, noisies = checked_batches(prog, rows)
    naf_init = prog.naf_init
    del prog
    _free(device)
    ref = denoise_steps(naf_init, config, cleans, noisies)
    losses, grad1, delta, pred1 = denoise_steps(naf_init, config, cleans, noisies, q8=check.fp8)
    params = {k: naf_init[k] + delta[k] for k in delta}
    first = (losses, grad1, params, None, [pred1])
    return numbers(first, ref, naf_init, cleans, noisies, config)


def run(config, traffic, seed, seconds, traced, device, t_start) -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    from naf_torch.kernels import launch_counts

    prog = Program(config, traffic, seed, dev)
    first = prog.first_steps(traffic["checked_steps"])
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    k = traffic["chunk_steps"]
    setup_s = time.time() - t_start
    chunk_s, host, losses = [], [], []
    while seconds > 0:  # whole chunks until the window is full; no window: the first steps alone
        t0 = time.perf_counter()
        dl, _ = prog.run_chunk(k)
        losses.extend(dl.float().cpu().tolist())
        chunk_s.append(time.perf_counter() - t0)
        if sum(chunk_s) >= seconds:
            break
    window_steps = len(losses)
    if traced:  # one more chunk, profiled, after the window: the profiler slows the host
        with trace.profiled() as holder:
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.call"):
                dl, _ = prog.run_chunk(k)
            host.append(time.perf_counter() - t0)
            losses.extend(dl.float().cpu().tolist())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    after = launch_counts()
    steps = len(losses)
    launches = {n: (after[n] - before[n]) / max(steps, 1) for n in after if after[n] != before[n]}
    window_s = sum(chunk_s) or float("nan")
    batch = config["train"]["batch_size"]
    failed = sum(1 for v in losses if not math.isfinite(v))
    naf_init = prog.naf_init
    cleans, noisies = checked_batches(prog, first[3])
    del prog
    _free(dev)
    ref = denoise_steps(naf_init, config, cleans, noisies)
    kept = {}
    nums = numbers(first, ref, naf_init, cleans, noisies, config, kept)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    res = {
        "attempted": steps, "failed": failed, "numbers": nums,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak)},
        "e2e": {"img_per_s": window_steps * batch / window_s, "peak_mib": peak / 2**20,
                "setup_s": setup_s},
        "window": {"calls": window_steps, "images": window_steps * batch,
                   "seconds": window_s} if chunk_s else None,
        "lines": [
            f"tf32: cudnn {torch.backends.cudnn.allow_tf32}, matmul "
            f"{torch.backends.cuda.matmul.allow_tf32}",
            f"window: {window_steps} steps in {len(chunk_s)} chunks, {window_s!r} s; set-up "
            f"{setup_s!r} s; profiled after it: {steps - window_steps} steps",
            f"launches per step: {launches}",
            f"chunk s: {chunk_s}",
            f"first steps: program losses {first[0]}, reference {ref[0]}",
            f"leaves (worst, compared, of): {kept}",
            f"window losses: first {losses[:1]}, last {losses[-1:]}",
        ],
    }
    if traced:
        tr = trace.reduce_profile(holder.prof)
        res.update(trace=tr, trace_calls=steps - window_steps, host_s=host,
                   work=work_per_step(config))
        res["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
    return res
