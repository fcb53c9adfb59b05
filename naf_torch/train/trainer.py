"""NAF upsampler training loop (counterpart of ``naf_tpu/train/trainer.py``,
reference train.py:30-174).

Self-distillation: hr_feats = backbone(image); lr_feats = backbone(downscaled
image); the model predicts hr_feats from (image, lr_feats) with MSE
(train.py:120-137). The numerics follow the JAX train step:

- f32 master parameters and AdamW state; with ``use_bf16`` each step casts
  the parameters to bf16 (``torch.func.functional_call``) and computes in
  bf16, and the gradients flow back through the casts to the f32 masters;
- the backbone targets under ``no_grad``;
- ``torch.optim.AdamW(lr, betas, eps=1e-8, weight_decay)``, which is optax
  ``adamw``'s update, over all parameters; the port updates the parameters
  and the optimizer state in place;
- the RoPE coordinate augmentation drawn per step from a generator seeded
  from (seed, step), so a step is reproducible on its own;
- ``use_checkpointing`` recomputes the model forward in the backward pass
  (``torch.utils.checkpoint``).

Each step is annotated for ``torch.profiler`` with the spans
(``naf_torch.utils.spans``) ``naf.backbone``, ``naf.forward``,
``naf.backward`` and ``naf.optimizer``.
Metrics stream to ``metrics.jsonl``; checkpoints (parameters, AdamW state and
step, ``torch.save``) make a resume exact.

With ``device_stack`` (the whole corpus resident on the card, see
``naf_torch.data.device_cached_stack``) training runs ``log_every`` steps per
call of :func:`make_train_chunk`, each batch gathered on the device by an
index vector and the chunk's losses read once at its end; ``lr_size`` is
drawn per chunk, as the JAX package's scanned chunk draws it.

With ``mesh`` (``naf_torch.parallel.make_mesh``, one process per rank) the
step is data parallel: each rank takes its shard of every global batch along
the mesh's ``cfg.data_axis``, and the gradients are averaged over that
group by an explicit ``all_reduce`` in f32 between the backward and the
optimizer, so N ranks take the one-process step on the whole batch. The
model is not wrapped in ``DistributedDataParallel``: the step runs it
through ``functional_call`` on bf16 casts of the masters (and under
``torch.utils.checkpoint``), a forward DDP's reducer does not see. Only the
group's first rank writes the run directory, metrics, panels and
checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from naf_torch.api import _device, _init_weights
from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from naf_torch.data.device_cache import index_batches
from naf_torch.models.naf import NAF
from naf_torch.nn.rope import RopeDraws
from naf_torch.ops.resize import resize_bilinear
from naf_torch.parallel import replicate, shard_batch
from naf_torch.train.distill import sample_lr_size
from naf_torch.train.losses import mse_loss
from naf_torch.utils.spans import span, to_device

__all__ = [
    "TrainConfig", "make_train_step", "make_train_chunk", "make_optimizer", "train_upsampler",
    "step_generator", "save_checkpoint", "load_checkpoint", "versioned_dir", "build_model",
]

_MODEL_KEYS = ("dim", "heads_attn", "heads_rope", "kernel_size", "use_encoder", "rope_base",
               "rope_rescale", "img_layers", "na_impl")


@dataclasses.dataclass
class TrainConfig:
    train_steps: int = 25_000  # config/base.yaml
    img_size: int = 512  # config/base.yaml
    lr: float = 2e-4  # config/optimizer/adamw.yaml
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 1e-4
    batch_size: int = 4  # config/dataloader/train.yaml
    down_factor: str = "fixed"  # "fixed" (0.5) | "random" (U(0.25, 0.60))
    use_bf16: bool = True
    use_checkpointing: bool = False  # recompute the model forward
    log_every: int = 100
    ckpt_every: Optional[int] = None  # default: train_steps // 4
    viz_every: Optional[int] = None  # default: ckpt_every; 0 disables
    log_dir: str = "runs/naf"
    seed: int = 0
    data_axis: str = "data"  # the mesh dim the batch shards over


def build_model(model_cfg: dict) -> NAF:
    """The port's NAF from a ``config/model`` node (its ``_target_`` names
    the JAX class, so the keys are read here)."""
    if model_cfg.get("name", "naf") != "naf":
        raise NotImplementedError(f"model {model_cfg.get('name')!r} is not ported")
    return NAF(**{k: model_cfg[k] for k in _MODEL_KEYS if k in model_cfg})


def step_generator(seed: int, step: int, device="cpu") -> torch.Generator:
    """The generator of one step's random draws (the RoPE augmentation on the
    CPU, a denoising step's noise on its batch's device), from (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def _cast_params(model, dtype):
    return {k: p.to(dtype) for k, p in model.named_parameters()}


def _sum_over(group, tensors, divisor: int = 1) -> None:
    """Replace each tensor by its sum over the ranks of ``group`` (None: the
    whole world) divided by ``divisor``, in place, with one ``all_reduce``
    of an f32 bucket."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= divisor
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _mean_over(group, tensors) -> None:
    """Replace each tensor by its mean over the ranks of ``group``, in place
    (:func:`_sum_over`)."""
    _sum_over(group, tensors, dist.get_world_size(group))


def make_train_step(model, backbone, optimizer, use_bf16: bool,
                    use_checkpointing: bool = False, seed: int = 0, grad_group=None):
    """Returns ``step(image_ups, image_back, step_idx, lr_size, out_hw,
    crop_hw, draws=None) -> loss``: one distillation step that updates the
    model's parameters and the optimizer in place. ``draws`` (a
    ``RopeDraws``) replaces the step's own augmentation draw. With
    ``grad_group`` (a process group of data-parallel ranks, each stepping on
    its equal shard of the batch) the gradients and the returned loss are
    their means over the group before the optimizer runs."""
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    rope = model.image_encoder.rope

    def step(image_ups, image_back, step_idx: int, lr_size, out_hw, crop_hw,
             draws: Optional[RopeDraws] = None):
        with span("naf.backbone"), torch.no_grad():
            hr_feats = backbone(image_back.to(dtype))
            lr_feats = backbone(resize_bilinear(image_back, lr_size).to(dtype))
        if draws is None:
            draws = rope.draw(step_generator(seed, step_idx))
        with span("naf.forward"):
            # the model input image: min(224, 4 * hr_size) (train.py:126)
            img_hr = resize_bilinear(image_ups, crop_hw).to(dtype)
            params = _cast_params(model, dtype)
            buffers = dict(model.named_buffers())

            def forward(img, feats):
                return functional_call(model, (params, buffers), (img, feats, out_hw),
                                       {"train": True, "draws": draws})

            if use_checkpointing:
                pred = torch.utils.checkpoint.checkpoint(forward, img_hr, lr_feats,
                                                         use_reentrant=False)
            else:
                pred = forward(img_hr, lr_feats)
            loss = mse_loss(pred, hr_feats)
        with span("naf.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            loss = loss.detach()
            if grad_group is not None:
                for p in model.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                mean_loss = loss.float().reshape(1).clone()
                _mean_over(grad_group, [*(p.grad for p in model.parameters()), mean_loss])
                loss = mean_loss[0]
        with span("naf.optimizer"):
            optimizer.step()
        return loss

    return step


def make_train_chunk(step, imagenet_stats, backbone_stats):
    """K train steps per call (counterpart of the JAX ``make_train_chunk``,
    whose ``lax.scan`` is a Python loop here): returns ``chunk(stack, idx,
    step0, lr_size, out_hw, crop_hw) -> losses``, where ``idx`` (K, B) holds
    batch indices into the resident ``stack`` (N, H, W, 3) in [0, 1], step
    ``step0 + i`` gathers its batch on the device and normalizes it with the
    model's (``imagenet_stats``) and the backbone's (``backbone_stats``)
    (mean, std) tensors, and the K losses come back as one device tensor.
    ``lr_size`` is one per chunk, as in the JAX package (a coarser draw of
    the reference's per-step distribution)."""
    (im_mean, im_std), (b_mean, b_std) = imagenet_stats, backbone_stats

    def chunk(stack, idx, step0: int, lr_size, out_hw, crop_hw) -> torch.Tensor:
        idx_dev = to_device(np.ascontiguousarray(idx, np.int64), stack.device)
        losses = torch.empty(idx_dev.shape[0], device=stack.device)
        for i in range(idx_dev.shape[0]):
            img = stack.index_select(0, idx_dev[i])
            losses[i] = step((img - im_mean) / im_std, (img - b_mean) / b_std, step0 + i,
                             lr_size, out_hw, crop_hw)
        return losses

    return chunk


@torch.no_grad()
def _viz(model, backbone, use_bf16, image_ups, image_back, lr_size, out_hw, crop_hw):
    """The distillation triple at eval time (no augmentation): (hr_feats,
    lr_feats, pred) for a qualitative panel."""
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    hr_feats = backbone(image_back.to(dtype))
    lr_feats = backbone(resize_bilinear(image_back, lr_size).to(dtype))
    img_hr = resize_bilinear(image_ups, crop_hw).to(dtype)
    pred = functional_call(model, (_cast_params(model, dtype), dict(model.named_buffers())),
                           (img_hr, lr_feats, out_hw))
    return hr_feats, lr_feats, pred


def write_viz_panel(log_dir, step, image, hr_feats, lr_feats, pred):
    """[image | PCA(lr) | PCA(pred) | PCA(hr target)] -> PNG, with one joint
    PCA so colours compare across panels."""
    from naf_torch.utils.visualization import plot_feats

    path = os.path.join(log_dir, f"panel_step{step:07d}.png")
    f32 = lambda t: t[0].float().cpu().numpy()
    plot_feats(f32(image), [f32(lr_feats), f32(pred), f32(hr_feats)], path=path)
    return path


def train_upsampler(model, backbone, data_iter: Optional[Iterator[np.ndarray]],
                    cfg: TrainConfig, params: Optional[dict] = None,
                    opt_state: Optional[dict] = None, start_step: int = 0, device="cuda",
                    device_stack: Optional[torch.Tensor] = None,
                    batch_size: Optional[int] = None, mesh=None,
                    records: Optional[list] = None):
    """Train ``model`` against the frozen ``backbone`` on images from
    ``data_iter`` (NHWC float [0, 1], (B, img_size, img_size, 3)), on
    ``device`` (CUDA unless asked otherwise; without CUDA it raises).

    ``params`` (a state dict) and ``opt_state`` (an AdamW state dict) resume
    from a checkpoint at ``start_step``; without ``params`` the model's
    weights are drawn from ``cfg.seed``. ``device_stack`` ((N, H, W, 3) f32
    on ``device``) replaces ``data_iter``: batches of ``batch_size``
    (default ``cfg.batch_size``) in the JAX package's epoch order, gathered
    on the device, ``log_every`` steps per chunk (:func:`make_train_chunk`),
    with the chunk's last loss logged and panels and checkpoints at the
    chunk that reaches their step. ``mesh`` (a ``naf_torch.parallel``
    mesh; this process is one of its ranks, on ``device``) trains data
    parallel over ``cfg.data_axis``: each rank steps on its shard of every
    batch ``data_iter`` yields (the whole batch, the same on every rank),
    the gradients and the logged loss are means over the ranks, and only
    the first rank writes. ``records``, a list, receives every record
    written to ``metrics.jsonl`` as it is written. Returns the model, its
    parameters f32 on ``device``."""
    dev = _device(device)
    if device_stack is not None and start_step:
        raise ValueError("the device-stack route starts at step 0, as the JAX package's does")
    if device_stack is not None and mesh is not None:
        raise ValueError("device_stack and mesh are mutually exclusive")
    if params is None:
        _init_weights(model, cfg.seed)
    else:
        model.load_state_dict(params)
    model.to(dev, torch.float32)
    backbone.to(dev)
    writer = mesh is None or dist.get_rank() == 0
    if mesh is not None:
        replicate(mesh, model)
    optimizer = make_optimizer(model, cfg)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    step_fn = make_train_step(model, backbone, optimizer, cfg.use_bf16,
                              cfg.use_checkpointing, seed=cfg.seed,
                              grad_group=None if mesh is None else mesh.get_group(cfg.data_axis))

    rng = np.random.RandomState(cfg.seed)
    ps = backbone.patch_size
    for _ in range(start_step):  # the lr sizes the skipped steps drew
        sample_lr_size((cfg.img_size, cfg.img_size), ps, cfg.down_factor, rng)
    stats = lambda a: to_device(a, dev, torch.float32)
    # the model's input takes ImageNet statistics, the backbone's its own
    im_mean, im_std = stats(IMAGENET_DEFAULT_MEAN), stats(IMAGENET_DEFAULT_STD)
    b_mean, b_std = stats(backbone.config["mean"]), stats(backbone.config["std"])

    log_dir = versioned_dir(cfg.log_dir) if writer else None
    ckpt_every = cfg.ckpt_every or max(cfg.train_steps // 4, 1)
    viz_every = ckpt_every if cfg.viz_every is None else cfg.viz_every
    t0 = time.time()

    def panel(step, img, img_ups, img_back, lr_size, hr_hw, crop_hw):
        try:
            triple = _viz(model, backbone, cfg.use_bf16, img_ups, img_back, lr_size, hr_hw,
                          crop_hw)
            write_viz_panel(log_dir, step, img, *triple)
        except Exception as e:  # a panel never stops a run, as in the JAX loop
            print(f"viz panel failed at step {step}: {e}", flush=True)

    if device_stack is not None:
        _train_chunked(model, optimizer, step_fn, device_stack, batch_size or cfg.batch_size,
                       cfg, rng, ps, (im_mean, im_std), (b_mean, b_std), log_dir, ckpt_every,
                       viz_every, panel, t0, records)
        return model
    metrics = (open(os.path.join(log_dir, "metrics.jsonl"), "a") if writer
               else contextlib.nullcontext())
    with metrics as mf:
        for step in range(start_step, cfg.train_steps):
            batch = next(data_iter)
            img = to_device(np.asarray(batch), dev, torch.float32)
            img_ups = (img - im_mean) / im_std
            img_back = (img - b_mean) / b_std
            lr_size = sample_lr_size(tuple(img.shape[1:3]), ps, cfg.down_factor, rng)
            hr_hw = (img.shape[1] // ps, img.shape[2] // ps)
            crop_hw = tuple(min(224, 4 * v) for v in hr_hw)
            x_ups, x_back = ((img_ups, img_back) if mesh is None else
                             (shard_batch(mesh, img_ups), shard_batch(mesh, img_back)))
            loss = step_fn(x_ups, x_back, step, lr_size, hr_hw, crop_hw)

            if step % cfg.log_every == 0 and writer:
                loss_v = float(loss)
                rec = {"step": step, "loss": loss_v, "lr_size": list(lr_size),
                       "elapsed_s": round(time.time() - t0, 1)}
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
                if records is not None:
                    records.append(rec)
                print(f"step {step}/{cfg.train_steps} loss {loss_v:.5f}", flush=True)
            if not writer:
                continue
            if viz_every and ((step + 1) % viz_every == 0 or step + 1 == cfg.train_steps):
                panel(step + 1, img, img_ups, img_back, lr_size, hr_hw, crop_hw)
            if (step + 1) % ckpt_every == 0 or step + 1 == cfg.train_steps:
                save_checkpoint(log_dir, step + 1, model, optimizer)
    return model


def _train_chunked(model, optimizer, step_fn, stack, batch_size, cfg, rng, ps, im_stats,
                   b_stats, log_dir, ckpt_every, viz_every, panel, t0, records=None):
    """``train_upsampler``'s device-stack loop (the JAX package's, chunk by
    chunk): ``rng`` draws each chunk's batch indices, then its lr size. Each
    chunk's record adds to the JAX package's keys the median of its losses
    and its wall time ``chunk_s``, up to the read of its losses."""
    chunk_fn = make_train_chunk(step_fn, im_stats, b_stats)
    img_hw = tuple(int(v) for v in stack.shape[1:3])
    hr_hw = (img_hw[0] // ps, img_hw[1] // ps)
    crop_hw = tuple(min(224, 4 * v) for v in hr_hw)
    stream = index_batches(stack.shape[0], batch_size, rng=rng)
    done = 0
    with open(os.path.join(log_dir, "metrics.jsonl"), "a") as mf:
        while done < cfg.train_steps:
            k = min(max(cfg.log_every, 1), cfg.train_steps - done)
            idx = np.stack([next(stream) for _ in range(k)])
            lr_size = sample_lr_size(img_hw, ps, cfg.down_factor, rng)
            t_chunk = time.perf_counter()
            losses = chunk_fn(stack, idx, done, lr_size, hr_hw, crop_hw).float().cpu()
            chunk_s = time.perf_counter() - t_chunk  # reading the losses waited for the chunk
            done += k
            rec = {"step": done - 1, "loss": float(losses[-1]), "lr_size": list(lr_size),
                   "elapsed_s": round(time.time() - t0, 1),
                   "loss_median": float(np.median(losses.numpy())), "chunk_s": chunk_s}
            mf.write(json.dumps(rec) + "\n")
            mf.flush()
            if records is not None:
                records.append(rec)
            print(f"step {done}/{cfg.train_steps} loss {rec['loss']:.5f}", flush=True)
            if viz_every and (done % max(viz_every, 1) < k or done >= cfg.train_steps):
                img = stack.index_select(0, to_device(idx[-1], stack.device))
                panel(done, img, (img - im_stats[0]) / im_stats[1],
                      (img - b_stats[0]) / b_stats[1], lr_size, hr_hw, crop_hw)
            if done % ckpt_every < k or done >= cfg.train_steps:
                save_checkpoint(log_dir, done, model, optimizer)


def versioned_dir(base: str) -> str:
    """``base/version_N`` with N = max existing + 1 (reference
    utils/training.py:53-65 logger semantics)."""
    os.makedirs(base, exist_ok=True)
    versions = [int(d.split("_")[-1]) for d in os.listdir(base)
                if d.startswith("version_") and d.split("_")[-1].isdigit()]
    path = os.path.join(base, f"version_{max(versions, default=-1) + 1}")
    os.makedirs(path, exist_ok=True)
    return path


def save_checkpoint(log_dir: str, step: int, model, optimizer=None) -> str:
    """``log_dir/ckpt_{step}.pt``: {"params", "opt_state", "step"}."""
    path = os.path.abspath(os.path.join(log_dir, f"ckpt_{step}.pt"))
    payload = {"params": model.state_dict(), "step": step}
    if optimizer is not None:
        payload["opt_state"] = optimizer.state_dict()
    torch.save(payload, path)
    return path


def load_checkpoint(path: str) -> dict:
    """A checkpoint written by :func:`save_checkpoint`, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
