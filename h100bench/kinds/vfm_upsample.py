"""Closed-loop backbone plus upsampling: one caller that waits for each
result, as the evaluations call a foundation model and NAF on one image
(batch 1 per call).

The traffic file fixes the shapes (``batch``, ``image``, ``output``), how
many distinct images the caller cycles through (``distinct_inputs``,
visited in an order drawn from the seed) and how many calls are held to the
reference (``checked_calls``, drawn among the first 20, plus the window's
last call). The configuration fixes the backbone (``backbone``: its name
and the published widths the program must resolve it to), NAF's widths and
the serving dtype.

The program is the normal path of ``naf_torch/examples/inference.py``'s
``upsample_panels`` and the evaluations:
``lr = PretrainedViTWrapper(name)(wrapper.normalize(img01))``, then
``NAFUpsampler(model)(image, lr, output, channels_last=True)``, NHWC, the
image resident on the card. DINOv3 normalises with ImageNet's statistics,
so NAF's guide is the backbone's normalised image. The backbone's weights
are drawn on the card (``weights_dinov3``) and handed to the wrapper, which
builds its model on the meta device: a draw on the host would hold 27 GB of
float32. A call is timed from before the normalisation to its output.

Numbers: ``feat_rel_l2``, the backbone's features against the reference's
(``reference/dinov3_vit.py``), and ``rel_l2`` / ``max_err``, the output
against the reference pipeline's (that ViT, then ``reference/naf.py``'s
NAF), each the worst over the checked calls. The reference runs after the
window on the same tensors, a block's weights in float32 at a time.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from h100bench import check, closed_loop, work, work_vit
from h100bench.kinds import upsample
from h100bench.reference import dinov3_vit
from h100bench.weights import draw, generator, naf_specs, subseed, uniform
from h100bench.weights_dinov3 import dinov3_specs, draw_parts

__all__ = ["Program", "build", "reference", "numbers", "work_per_call", "run"]

# the configuration's backbone fields the program's resolution must give
_FIELDS = ("patch_size", "embed_dim", "depth", "num_heads", "ffn", "mlp_hidden",
           "num_reg_tokens", "rope_theta", "ln_eps", "qkv_bias", "layerscale", "patch_bias")


@dataclasses.dataclass
class Program:
    backbone: object  # naf_torch.backbones.PretrainedViTWrapper
    ups: object  # naf_torch.api.NAFUpsampler
    vit_state: dict  # the backbone's weights, as drawn (the model's own tensors)
    naf_state: dict
    images: list  # (B, H, W, 3) in [0, 1], serving dtype
    order: np.ndarray
    checked: list
    out_hw: tuple

    def __call__(self, j: int):
        x = self.backbone.normalize(self.images[j])
        lr = self.backbone(x)
        return lr, self.ups(x, lr, self.out_hw, channels_last=True)


def build(config: dict, traffic: dict, seed: int, device) -> Program:
    from naf_torch.api import NAFUpsampler
    from naf_torch.backbones.wrapper import PretrainedViTWrapper, backbone_config
    from naf_torch.models.naf import NAF

    bcfg = config["backbone"]
    _, vcfg = backbone_config(bcfg["name"])
    wrong = {k: (getattr(vcfg, k, None), bcfg[k]) for k in _FIELDS
             if getattr(vcfg, k, None) != bcfg[k]}
    if wrong:  # before any draw: a program without the published shape fails at once
        raise RuntimeError(f"the program resolves {bcfg['name']} to another shape than the "
                           f"configuration's (program, configuration): {wrong}")
    dtype = getattr(torch, config["dtype"])
    vit_state = draw_parts(dinov3_specs(bcfg), generator(seed, "backbone", device), dtype)
    backbone = PretrainedViTWrapper(bcfg["name"], dtype=dtype, device=device, state=vit_state)
    naf_state = draw(naf_specs(config["model"]), generator(seed, "weights", device), dtype)
    with torch.device(device):
        model = NAF(**config["model"])
    missing, unexpected = model.load_state_dict(naf_state, strict=False)
    if unexpected or set(missing) != {"image_encoder.rope.periods"}:
        raise RuntimeError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    model = model.to(device, dtype).eval()
    gen = generator(seed, "inputs", device)
    images = [uniform(gen, (traffic["batch"], *traffic["image"], 3), dtype)
              for _ in range(traffic["distinct_inputs"])]
    order, checked = closed_loop.draw_calls(np.random.default_rng(subseed(seed, "order")),
                                            traffic["distinct_inputs"], traffic["checked_calls"])
    return Program(backbone, NAFUpsampler(model=model), vit_state, naf_state, images, order,
                   checked, tuple(traffic["output"]))


def _normalised(prog: Program, image01):
    """The image as the reference takes it: ImageNet-normalised in f32."""
    mean = torch.tensor(prog.backbone.config["mean"], device=image01.device)
    std = torch.tensor(prog.backbone.config["std"], device=image01.device)
    return (image01.float() - mean) / std


@torch.no_grad()
def reference(config: dict, prog: Program, image01, q8=None):
    """(features, output) of the reference pipeline for one image, f32 NHWC
    (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = {} if q8 is None else {"q8": q8}
        return dinov3_vit.pipeline(prog.vit_state, config["backbone"], prog.naf_state,
                                   config["model"], _normalised(prog, image01), prog.out_hw, **kw)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def numbers(triples) -> dict:
    """The worst over the checked calls of ``feat_rel_l2`` (features) and
    of ``upsample.numbers``' ``rel_l2`` and ``max_err`` (output); each item
    is ((features, output), (ref features, ref output)), taken one at a
    time."""
    nums = {"rel_l2": 0.0, "max_err": 0.0, "feat_rel_l2": 0.0}
    for (f, o), (rf, ro) in triples:
        one = upsample.numbers([(o, ro)])
        one["feat_rel_l2"] = check.rel_l2(f, rf)
        nums = {k: max(v, one[k]) for k, v in nums.items()}
    return nums


def work_per_call(config: dict, traffic: dict) -> dict:
    m, bcfg, b = config["model"], config["backbone"], traffic["batch"]
    (h, w), out_hw = traffic["image"], tuple(traffic["output"])
    c, ps = config["values"]["channels"], bcfg["patch_size"]
    lr_hw = (h // ps, w // ps)
    enc_hw = upsample.guard_hw(h, w, *out_hw)
    vit = work_vit.vit_work(b, h, w, bcfg)
    return {"k1": work.k1_work(b, *enc_hw, m["dim"], m["img_layers"]),
            "k2": work.k2_work(b, enc_hw, out_hw, lr_hw, m["dim"], m["heads_attn"],
                               m["kernel_size"], c),
            "vit": vit, "flops": vit[0] + work.naf_forward_flops(b, enc_hw, out_hw, m, c)}


def run(config, traffic, seed, seconds, traced, device, t_start) -> dict:
    dev = torch.device(device)
    prog = build(config, traffic, seed, dev)
    loop = closed_loop.closed_loop(prog, prog.order, prog.checked, seconds, traced, dev, t_start)
    served = loop.pop("served")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def triples():
        for outs, c in served:
            yield outs, reference(config, prog, prog.images[int(prog.order[c % len(prog.order)])])

    t0 = time.perf_counter()
    nums = numbers(triples())
    ref_s = time.perf_counter() - t0
    return closed_loop.result(loop, nums, traffic["batch"], dev, traced,
                              work_per_call(config, traffic),
                              [f"reference and comparison: {ref_s!r} s for {len(served)} calls"])
