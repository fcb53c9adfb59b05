"""The self-distillation training step, driven as ``train_upsampler``'s
device-stack route drives it: ``make_train_chunk`` over ``make_train_step``,
``chunk_steps`` steps a call on batches gathered on the card from a resident
stack of seeded images.

Set-up builds one training object (NAF's f32 masters, AdamW, the bf16
teacher) and drives it from the seed through its first ``checked_steps``
steps, a chunk of one step each, on rows that all differ; it keeps each
step's loss, the first gradient as AdamW holds it (its first moment over
1 - beta1) and the masters after the last. The same object then trains
through the window in whole chunks; a traced run profiles one chunk more,
after the window, so that the window's rate is the unprofiled one. After
the window the reference takes those steps from the same weights and
images; the numbers compared are the worst step's loss gap, and the worst
leaf's gap of the first gradient's norm and of the masters' change.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from h100bench import check, trace, work
from h100bench.reference.distill import distill_steps
from h100bench.weights import draw, generator, naf_specs, subseed, uniform, vit_specs

__all__ = ["Program", "numbers", "run", "shapes", "work_per_step"]


def shapes(config: dict):
    """(image side, LR side, target grid side, crop side): the teacher's
    patch grid of the image, half the image rounded to whole patches, and
    the model's input, min(224, 4 x the grid)."""
    ps, size = config["teacher"]["patch_size"], config["img_size"]
    hr = size // ps
    return size, int(ps * round(size * 0.5 / ps)), hr, min(224, 4 * hr)


def _batches(rng, rows: int, batch: int):
    """Batches of distinct rows: consecutive slices of seeded permutations."""
    while True:
        perm = rng.permutation(rows)
        for i in range(0, rows - batch + 1, batch):
            yield perm[i:i + batch]


class Program:
    def __init__(self, config, traffic, seed, device):
        from naf_torch.backbones.vit import ViT
        from naf_torch.backbones.wrapper import backbone_config
        from naf_torch.models.naf import NAF
        from naf_torch.train.trainer import (
            TrainConfig, make_optimizer, make_train_chunk, make_train_step,
        )

        tr, tcfg = config["train"], config["teacher"]
        self.config, self.traffic = config, traffic
        self.rope_seed = subseed(seed, "rope")
        self.naf_init = draw(naf_specs(config["model"]), generator(seed, "weights", device),
                             torch.float32)
        with torch.device(device):
            model = NAF(**config["model"])
        missing, unexpected = model.load_state_dict(self.naf_init, strict=False)
        if unexpected or set(missing) != {"image_encoder.rope.periods"}:
            raise RuntimeError(f"NAF weights do not fit: {missing}, {unexpected}")
        self.model = model.to(device)
        dtype = torch.bfloat16 if tr["use_bf16"] else torch.float32
        self.teacher_state = draw(vit_specs(tcfg), generator(seed, "teacher", device), dtype)
        stats, vcfg = backbone_config(tcfg["name"])
        for key in ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio", "pos_grid",
                    "ln_eps"):
            if getattr(vcfg, key) != tcfg[key]:
                raise RuntimeError(f"the teacher's {key} is {getattr(vcfg, key)} in the program, "
                                   f"{tcfg[key]} in the configuration")
        with torch.device(device):
            teacher = ViT(vcfg)
        teacher.load_state_dict(self.teacher_state)
        self.teacher = teacher.to(device, dtype).eval().requires_grad_(False)
        tc = TrainConfig(lr=tr["lr"], b1=tr["b1"], b2=tr["b2"], weight_decay=tr["weight_decay"],
                         batch_size=tr["batch_size"], use_bf16=tr["use_bf16"],
                         use_checkpointing=tr["use_checkpointing"], seed=self.rope_seed)
        self.optimizer = make_optimizer(self.model, tc)
        step = make_train_step(self.model, self.teacher, self.optimizer, tc.use_bf16,
                               tc.use_checkpointing, seed=self.rope_seed)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.chunk = make_train_chunk(step, (t((0.485, 0.456, 0.406)), t((0.229, 0.224, 0.225))),
                                      (t(stats["mean"]), t(stats["std"])))
        size, lr_side, hr, crop = shapes(config)
        self.lr_size, self.hr_hw, self.crop_hw = (lr_side, lr_side), (hr, hr), (crop, crop)
        self.stack = uniform(generator(seed, "images", device),
                             (traffic["stack_images"], size, size, 3), torch.float32)
        self.feed = _batches(np.random.default_rng(subseed(seed, "feed")), traffic["stack_images"],
                             tr["batch_size"])
        self.steps = 0

    def run_chunk(self, k: int):
        """Launch ``k`` steps; returns the chunk's losses on the device."""
        idx = np.stack([next(self.feed) for _ in range(k)])
        losses = self.chunk(self.stack, idx, self.steps, self.lr_size, self.hr_hw, self.crop_hw)
        self.steps += k
        return losses, idx

    def first_steps(self, n: int):
        """The checked steps, a chunk of one each: (losses, first gradient,
        masters after the last, the rows of each step)."""
        losses, rows, grad1 = [], [], None
        b1 = self.config["train"]["b1"]
        names = dict(self.model.named_parameters())
        for s in range(n):
            loss, idx = self.run_chunk(1)
            losses.append(float(loss[0]))
            rows.append(idx[0])
            if s == 0:  # a leaf AdamW holds no moment of counts as a zero gradient
                state = self.optimizer.state
                grad1 = {k: state[p]["exp_avg"].detach() / (1 - b1) if "exp_avg" in state[p]
                         else torch.zeros_like(p) for k, p in names.items()}
        params = {k: p.detach().clone() for k, p in names.items()}
        return losses, grad1, params, rows


def numbers(prog_losses, grad1, params, naf_init, ref, kept=None) -> dict:
    """The three numbers compared; ``kept``, a dict, receives each gap's
    worst leaf and how many leaves it compared."""
    ref_losses, ref_grad1, ref_delta = ref
    delta = {k: params[k] - naf_init[k] for k in params}
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    grad = check.leaf_gap(grad1, ref_grad1)
    dlt = check.leaf_gap(delta, ref_delta)
    if kept is not None:
        kept.update(grad=(grad[1], grad[2], len(ref_grad1)), delta=(dlt[1], dlt[2], len(ref_delta)))
    return {"loss_gap": loss_gap, "grad_gap": grad[0], "delta_gap": dlt[0]}


def work_per_step(config: dict) -> dict:
    """The step's K1 work and its FLOPs: the teacher's two forwards, and
    NAF's forward and backward at 3x the forward."""
    size, lr_side, hr, crop = shapes(config)
    b, m, t = config["train"]["batch_size"], config["model"], config["teacher"]
    c = t["embed_dim"]
    flops = (work.vit_forward_flops(b, size, size, t) + work.vit_forward_flops(b, lr_side, lr_side, t)
             + 3 * work.naf_forward_flops(b, (crop, crop), (hr, hr), m, c))
    return {"k1": work.k1_work(b, crop, crop, m["dim"], m["img_layers"]), "flops": flops}


def run(config, traffic, seed, seconds, traced, device, t_start) -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    from naf_torch.kernels import launch_counts

    prog = Program(config, traffic, seed, dev)
    first = prog.first_steps(traffic["checked_steps"])
    rows = first[3]
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
    naf_init, teacher, stack = prog.naf_init, prog.teacher_state, prog.stack
    batches = [stack.index_select(0, torch.as_tensor(r, device=dev)) for r in rows]
    del prog, stack
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = distill_steps(naf_init, teacher, config, batches, subseed(seed, "rope"))
    kept = {}
    nums = numbers(first[0], first[1], first[2], naf_init, ref, kept)
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
