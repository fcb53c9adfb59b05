"""A multi-rank dry run of the port (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``), and the per-rank cases it, the tests and
``chip_smoke.py`` run.

    python -m naf_torch.dryrun --ranks 4                 # N ranks on the card(s)
    python -m naf_torch.dryrun --ranks 4 --device cpu    # gloo on the CPU

Starts N ranks (spawned processes, a file rendezvous: ``parallel.run_ranks``)
and, on every rank: one data-parallel train step of the flagship NAF (dim
256, 4 heads, k 9) over all N ranks on a (N, 1) mesh, against a small random
DINOv2 ViT, with a finite loss; then the spatially sharded forward
(``parallel.naf_spatial_forward``) of the same model on a (N/2, 2) mesh for
even N, (N, 1) otherwise, at 8 * space LR rows (the JAX dry run's shapes),
gathered whole, with the expected shape and finite values; then one
spatially sharded train step (``parallel.naf_spatial_train_step``, AdamW
2e-4) of the flagship NAF on that mesh at the JAX dry run's training shapes
(output (48 * space, 48), image (B, 96 * space, 96, 3), features (B, 12 *
space, 12, 32), a (B, 48 * space, 48, 32) target), with a finite loss that
every rank holds. Prints ``DRYRUN_OK``. Ranks that share a card talk over
gloo; ranks with a card each over NCCL.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from naf_torch.parallel import rank_device
from naf_torch.utils.spans import to_device

__all__ = ["spatial_case", "train_case", "spatial_train_case", "each", "main"]


def _counts() -> dict:
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused as na
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    return {"k1": gn_silu_conv_fused.launches, "k2": naf_upsample_attention.launches,
            **{f"k2_{k}": v for k, v in naf_upsample_attention.route_launches.items()},
            "k3": na.launches, "k4": na.bwd_launches,
            **{f"k34_{k}": v for k, v in na.route_launches.items()}}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _compare(got: torch.Tensor, want: torch.Tensor, chunk: int = 1 << 24) -> dict:
    """Max abs error and cosine of two tensors in float64, a chunk of
    elements at a time."""
    got, want = got.flatten(), want.flatten()
    err = dot = na = nb = 0.0
    for i in range(0, got.numel(), chunk):
        x, y = got[i : i + chunk].double(), want[i : i + chunk].double()
        err = max(err, float((x - y).abs().max()))
        dot, na, nb = dot + float(x @ y), na + float(x @ x), nb + float(y @ y)
    return {"max_abs_err": err, "cos": dot / max((na * nb) ** 0.5, 1e-300)}


def _model(spec, dev, dtype):
    from naf_torch.api import _init_weights
    from naf_torch.models.naf import NAF

    model = NAF(**spec["naf"])
    if spec.get("state") is not None:
        model.load_state_dict(spec["state"])
    else:
        _init_weights(model, spec.get("seed", 0))
    return model.to(dev, dtype).eval()


def spatial_case(spec: dict) -> dict:
    """One rank's sharded forward, run under :func:`parallel.run_ranks`.

    ``spec``: ``naf`` (NAF keyword arguments), ``state`` (a state dict, or
    None for weights drawn from ``seed``), ``image`` (B, H, W, 3) and
    ``feats`` (B, hk, wk, C) numpy arrays (the whole batch, NHWC),
    ``out_hw``, ``data`` and ``space`` (the mesh), ``dtype`` ("float32" or
    "bfloat16"), ``route`` ("spatial": ``naf_spatial_forward``; "pjit":
    ``pjit_upsample``), ``compare`` (rank 0 also runs the one-process
    forward and compares the gathered output with it), ``return_out``
    (return the gathered output, on the CPU).

    Returns this rank's kernel launches (K1, K2, K2 by route) and mean wall
    time over ``reps`` sharded calls (default 1; after one that builds
    plans), on the card one more call's own peak memory, its block's shape,
    and as asked the gathered output and the comparison (the one-process
    forward timed over as many calls)."""
    import torch.distributed as dist

    from naf_torch.parallel import (
        gather, make_mesh, naf_spatial_forward, pjit_upsample, replicate, shard_spatial,
    )

    dev = rank_device()
    dtype = getattr(torch, spec.get("dtype", "float32"))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model = _model(spec, dev, dtype)
    mesh = make_mesh(spec["data"], spec["space"])
    replicate(mesh, model)
    image = to_device(spec["image"], dev, dtype)
    feats = to_device(spec["feats"], dev, dtype)
    out_hw = tuple(spec["out_hw"])
    if spec.get("route", "spatial") == "spatial":
        fwd = lambda: naf_spatial_forward(mesh, model, image, feats, out_hw)  # noqa: E731
    else:
        run = pjit_upsample(mesh, model)

        def fwd():
            with torch.inference_mode():
                return run(image, feats, out_hw)

    reps = spec.get("reps", 1)
    fwd()  # plans and caches
    _sync(dev)
    dist.barrier()
    before = _counts()
    t0 = time.perf_counter()
    for _ in range(reps):
        block = fwd()
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    res = {"launches": {k: v - before[k] for k, v in _counts().items()}, "ms": ms, "reps": reps,
           "block": tuple(block.shape), "rank": dist.get_rank(), "backend": dist.get_backend()}
    if dev.type == "cuda":  # one call's own peak, its block included
        del block
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        block = fwd()
        _sync(dev)
        res["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    out = gather(mesh, block)
    res["gather_inverts_shard"] = torch.equal(shard_spatial(mesh, out), block)
    del block
    if spec.get("return_out"):
        res["out"] = out.cpu() if dist.get_rank() == 0 else None
    if spec.get("compare") and dist.get_rank() == 0:
        single = lambda: model(image, feats, out_hw)  # noqa: E731
        with torch.inference_mode():
            single()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                want = single()
            _sync(dev)
        res.update(_compare(out, want), shape=tuple(out.shape), single_ms=(
            time.perf_counter() - t0) * 1e3 / reps, finite=bool(torch.isfinite(out).all()))
    dist.barrier()  # the other ranks wait while rank 0 compares
    return res


def _backbone(spec, dev, dtype):
    """The frozen backbone: a ViT from ``backbone_state`` and
    ``backbone_config`` (``ViTConfig`` fields), else a random DINOv2 wrapper
    from ``backbone`` (``PretrainedViTWrapper`` keyword arguments)."""
    from naf_torch.backbones import PretrainedViTWrapper, ViT, ViTConfig

    if spec.get("backbone_state") is not None:
        vit = ViT(ViTConfig(**spec["backbone_config"]))
        vit.load_state_dict(spec["backbone_state"])
        return vit.to(dev, dtype).eval().requires_grad_(False)
    return PretrainedViTWrapper(dtype=dtype, device=dev, **spec["backbone"])


def _steps(spec, model, backbone, dev, mesh=None):
    """Run ``spec``'s train steps, on this rank's shard of the batch with
    the gradients averaged over the ``data`` group when ``mesh`` is given;
    returns the losses, the gradients the first step applied and the
    parameters after the last step, on the CPU, and each step's wall time."""
    from naf_torch.nn.rope import RopeDraws
    from naf_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

    cfg = TrainConfig(lr=spec.get("lr", 2e-4), weight_decay=spec.get("weight_decay", 1e-4))
    opt = make_optimizer(model, cfg)
    step = make_train_step(model, backbone, opt, spec["use_bf16"], seed=spec.get("seed", 0),
                           grad_group=None if mesh is None else mesh.get_group("data"))
    ups, back = (to_device(spec[k], dev) for k in ("ups", "back"))
    if mesh is not None:
        from naf_torch.parallel import shard_batch

        ups, back = shard_batch(mesh, ups), shard_batch(mesh, back)
    draws = spec.get("draws")
    losses, grads, ms = [], None, []
    for i in range(spec["steps"]):
        t0 = time.perf_counter()
        loss = step(ups, back, i, tuple(spec["lr_size"]), tuple(spec["out_hw"]),
                    tuple(spec["crop_hw"]),
                    draws=None if draws is None else RopeDraws(**draws[i]))
        losses.append(float(loss))
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads = {k: p.grad.detach().float().cpu().clone()
                     for k, p in model.named_parameters()}
    params = {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()}
    return {"losses": losses, "grads": grads, "params": params, "ms": ms}


def train_case(spec: dict) -> dict:
    """One rank's data-parallel train steps, run under
    :func:`parallel.run_ranks`: the port's ``make_train_step`` with its
    gradients averaged over the mesh's ``data`` group, each rank on its
    shard of the batch.

    ``spec``: ``naf``, ``state`` and ``seed`` as in :func:`spatial_case`;
    the backbone (:func:`_backbone`); ``ups`` and ``back`` (the whole batch,
    normalised for the model and for the backbone, (B, H, W, 3) numpy);
    ``steps``, ``lr_size``, ``out_hw``, ``crop_hw``, ``use_bf16``, ``lr``,
    ``weight_decay``; ``draws`` (one ``RopeDraws`` field dict per step, or
    None for the steps' own draws); ``one_process`` (rank 0 also runs the
    same steps on the whole batch in one process, from the same weights).

    Returns ``dp`` (the losses, the gradients the first step applied, the
    parameters after the last step, per-step wall times, peak memory) and,
    on rank 0 with ``one_process``, ``single`` the same for the one-process
    run."""
    import torch.distributed as dist

    from naf_torch.parallel import make_mesh, replicate

    dev = rank_device()
    if dev.type == "cuda" and not spec["use_bf16"]:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    bdtype = torch.bfloat16 if spec["use_bf16"] else torch.float32
    backbone = _backbone(spec, dev, bdtype)
    model = _model(spec, dev, torch.float32).train()
    mesh = make_mesh(data=dist.get_world_size(), space=1)
    replicate(mesh, model)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = {"dp": _steps(spec, model, backbone, dev, mesh),
           "rank": dist.get_rank(), "backend": dist.get_backend()}
    if dev.type == "cuda":
        res["dp"]["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    if spec.get("one_process") and dist.get_rank() == 0:
        single = _model(spec, dev, torch.float32).train()
        res["single"] = _steps(spec, single, backbone, dev)
    return res


def _mse_steps(model, optimizer, step_fn, steps: int, dev) -> dict:
    """Run ``steps`` calls of ``step_fn() -> loss``; returns the losses, the
    gradients the first step applied and the parameters after the last, on
    the CPU in f32, each step's wall time and kernel launches, and on the
    card the steps' peak over what was allocated before the model's first
    step (its parameters, optimizer state and activations)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, grads, ms, launches = [], None, [], []
    for i in range(steps):
        before = _counts()
        t0 = time.perf_counter()
        losses.append(float(step_fn()))
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: v - before[k] for k, v in _counts().items()})
        if i == 0:
            grads = {k: p.grad.detach().float().cpu().clone()
                     for k, p in model.named_parameters()}
    res = {"losses": losses, "grads": grads, "ms": ms, "launches": launches,
           "params": {k: v.detach().float().cpu().clone()
                      for k, v in model.state_dict().items()}}
    if dev.type == "cuda":
        res["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    return res


def spatial_train_case(spec: dict) -> dict:
    """One rank's spatially sharded train steps, run under
    :func:`parallel.run_ranks`: ``parallel.naf_spatial_train_step`` on a
    (data, space) mesh, the counterpart of the JAX dry run's
    ``value_and_grad`` step of ``mean((model.apply(p, image, lr_feats,
    out_hw) - target)**2)`` with ``optax.adamw``.

    ``spec``: ``naf``, ``state`` and ``seed`` as in :func:`spatial_case`;
    ``image`` (B, H, W, 3), ``feats`` (B, hk, wk, C) and ``target`` (B, Ho,
    Wo, C) numpy arrays (the whole batch; each rank cuts its target block
    with ``shard_spatial``), or instead of ``target`` a ``target_shape``
    drawn on the rank's device from ``target_seed`` in the step's dtype (a
    2048^2 target is too large to pass through a file); ``out_hw``,
    ``data``, ``space``, ``use_bf16``, ``steps``; ``one_process`` (rank 0
    also takes the same steps through ``model(image, feats, out_hw)`` on the
    whole batch, from the same weights, in one process; bf16 on casts of f32
    masters, as the trainer does).

    The optimizer is the JAX dry run's ``optax.adamw(2e-4)``: AdamW at lr
    2e-4 and optax's default weight decay, 1e-4.

    Returns ``spatial`` (:func:`_mse_steps`: the losses, the reduced
    gradients the first step applied, the parameters after the last step,
    per-step ms and kernel launches, the peak MiB on the card) and, on rank
    0 with ``one_process``, ``single`` the same for the one-process steps."""
    import torch.distributed as dist
    from torch.func import functional_call

    from naf_torch.parallel import make_mesh, naf_spatial_train_step, replicate, shard_spatial
    from naf_torch.train.trainer import TrainConfig, _cast_params, make_optimizer

    dev = rank_device()
    use_bf16 = spec["use_bf16"]
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    if dev.type == "cuda" and not use_bf16:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(spec["data"], spec["space"])
    image, feats = (to_device(spec[k], dev) for k in ("image", "feats"))
    if spec.get("target") is not None:
        target = to_device(spec["target"], dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(spec["target_seed"])
        target = torch.randn(tuple(spec["target_shape"]), generator=gen, device=dev,
                             dtype=dtype)
    out_hw = tuple(spec["out_hw"])
    adamw = TrainConfig(lr=2e-4, weight_decay=1e-4)

    def spatial():
        model = _model(spec, dev, torch.float32).train()
        replicate(mesh, model)
        opt = make_optimizer(model, adamw)
        step = naf_spatial_train_step(mesh, model, opt, use_bf16)
        block = shard_spatial(mesh, target)
        return _mse_steps(model, opt, lambda: step(image, feats, block, out_hw),
                          spec["steps"], dev)

    def single():
        model = _model(spec, dev, torch.float32).train()
        opt = make_optimizer(model, adamw)

        def step():
            pred = functional_call(model, _cast_params(model, dtype),
                                   (image.to(dtype), feats.to(dtype), out_hw))
            loss = (pred.float() - target.float()).square().mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

        return _mse_steps(model, opt, step, spec["steps"], dev)

    res = {"spatial": spatial(), "rank": dist.get_rank(), "backend": dist.get_backend()}
    if spec.get("one_process") and dist.get_rank() == 0:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res["single"] = single()
    dist.barrier()  # the other ranks wait while rank 0 steps alone
    return res


def each(calls) -> list:
    """Run each ``(case, spec)`` of ``calls`` in turn on this rank: several
    cases in one world, for the price of one start of the ranks."""
    return [case(spec) for case, spec in calls]


def _dryrun_rank(n: int) -> dict:
    """The dry run on one rank: a data-parallel train step over all ranks,
    then the spatially sharded forward of the flagship NAF."""
    import torch.distributed as dist

    from naf_torch.parallel import gather, make_mesh, naf_spatial_forward

    rng = np.random.RandomState(0)
    # 252^2 images: 18^2 target features, 9^2 LR ones (k 9 needs 9 cells a side)
    img = rng.rand(n, 252, 252, 3).astype(np.float32)
    train = train_case(dict(
        naf={}, seed=0, backbone=dict(name="vit_small_patch14_dinov2.lvd142m", embed_dim=64,
                                      depth=1, num_heads=2, seed=0),
        ups=(img - 0.45) / 0.225, back=(img - 0.5) / 0.25, steps=1, lr_size=(126, 126),
        out_hw=(18, 18), crop_hw=(72, 72), use_bf16=False))
    loss = train["dp"]["losses"][0]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss} in the data-parallel step")
    space = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n // space, space)
    dev = rank_device()
    model = _model({"naf": {}, "seed": 0}, dev, torch.float32)
    batch, hk = n // space, 8 * space
    image = to_device(rng.randn(batch, hk, 64, 3).astype(np.float32), dev)
    feats = to_device(rng.randn(batch, hk, 32, 384).astype(np.float32), dev)
    out = gather(mesh, naf_spatial_forward(mesh, model, image, feats, (hk * 8, 256)))
    if tuple(out.shape) != (batch, hk * 8, 256, 384) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sharded forward: shape {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    # the JAX dry run's (data, space) train step: its shapes, AdamW 2e-4
    rng = np.random.RandomState(0)
    out_hw = (48 * space, 48)
    st = spatial_train_case(dict(
        naf={}, seed=0, image=rng.randn(batch, 96 * space, 96, 3).astype(np.float32),
        feats=rng.randn(batch, 12 * space, 12, 32).astype(np.float32),
        target=rng.randn(batch, *out_hw, 32).astype(np.float32), out_hw=out_hw,
        data=n // space, space=space, use_bf16=False, steps=1))
    spatial_loss = st["spatial"]["losses"][0]
    if not np.isfinite(spatial_loss):
        raise AssertionError(f"non-finite loss {spatial_loss} in the spatial train step")
    return {"rank": dist.get_rank(), "backend": dist.get_backend(), "loss": loss,
            "mesh": (n // space, space), "out": tuple(out.shape), "spatial_loss": spatial_loss}


def main(argv=None) -> int:
    from naf_torch.parallel import run_ranks

    ap = argparse.ArgumentParser(prog="python -m naf_torch.dryrun", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before every rank is killed and the run fails")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = run_ranks(_dryrun_rank, args.ranks, args=(args.ranks,), device=args.device,
                    timeout=args.timeout)
    for r in res:
        print(f"rank {r['rank']} ({r['backend']}): train loss {r['loss']:.6f}, spatial mesh "
              f"{r['mesh']}, gathered output {r['out']}", flush=True)
    losses = {r["spatial_loss"] for r in res}
    if len(losses) != 1:
        raise AssertionError(f"the ranks' spatial train losses differ: {sorted(losses)}")
    print(f"spatial train step on mesh {res[0]['mesh']}: loss {res[0]['spatial_loss']:.6f} on "
          f"every rank", flush=True)
    print(f"{args.ranks} ranks in {time.perf_counter() - t0:.1f} s", flush=True)
    print("DRYRUN_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
