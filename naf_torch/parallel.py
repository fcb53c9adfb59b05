"""Data and spatial parallelism over ranks (counterpart of ``naf_tpu/parallel.py``).

The JAX package places arrays on a (data, space) device mesh and lets XLA
partition one program. Here every rank is a process with a
``torch.distributed`` process group, and the collectives are written out:

    dev = init_distributed()                 # RANK / WORLD_SIZE / LOCAL_RANK (torchrun)
    mesh = make_mesh(data=2, space=2)        # a DeviceMesh, dims ("data", "space")
    replicate(mesh, model)                   # rank 0's parameters and buffers everywhere
    block = naf_spatial_forward(mesh, model, image, lr_feats, (H, W))  # this rank's block
    out = gather(mesh, block)                # the whole (B, H, W, C) output, NHWC
    step = naf_spatial_train_step(mesh, model, optimizer, use_bf16=False)
    loss = step(image, lr_feats, shard_spatial(mesh, target), (H, W))  # the global loss

Batches shard over ``data``. The query grid, the only axis that grows with
the output, shards over ``space``: each rank owns a band of LR cell rows and
the output rows above them. The LR keys and values are small by construction
and every rank holds them whole, so the attention needs no collective. The
conv encoder is computed on each rank's rows plus a halo, with its GroupNorm
statistics summed over ``space`` by ``all_reduce``: the counterpart of the
halo exchanges and the statistics reduction XLA inserts under ``jit``.
Training runs the same band with gradients (:func:`naf_spatial_train_step`):
the statistics and keys are summed by a differentiable ``all_reduce``, whose
backward sums their gradients over ``space`` again, and one ``all_reduce``
of the flat parameter gradients joins the ranks before the optimizer.

:func:`run_ranks` starts N ranks as spawned processes with a file
rendezvous (the dry run, the tests and ``chip_smoke.py`` use it); under
``torchrun`` a program calls :func:`init_distributed` itself. NCCL serves
ranks that each have a card of their own, gloo ranks that share a card or
run on the CPU. Every process group times out after :data:`PG_TIMEOUT`, so
a rank that hangs fails its peers in seconds.
"""

from __future__ import annotations

import os
import tempfile
import time
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "PG_TIMEOUT",
    "init_distributed",
    "rank_device",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_spatial",
    "gather",
    "naf_spatial_forward",
    "naf_spatial_train_step",
    "pjit_upsample",
    "run_ranks",
]

PG_TIMEOUT = timedelta(seconds=120)


def init_distributed(device="cuda", init_method: str = "env://",
                     timeout: timedelta = PG_TIMEOUT) -> torch.device:
    """Join the process group described by ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (torchrun's variables; without
    them a world of one) and return this rank's device: ``cuda:LOCAL_RANK %
    device_count()``, made current, unless ``device`` asks for the CPU. The
    backend is NCCL where every rank of the host has a card of its own, gloo
    where ranks share a card, and gloo on the CPU."""
    from naf_torch.api import _device

    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = _device(device)
    backend = "gloo"
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
        if local_world <= count:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=timeout)
    return dev


def rank_device() -> torch.device:
    """This process's device: the card :func:`init_distributed` made
    current, else the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _axis(mesh, name: str):
    """(size, this rank's index) of a mesh dim."""
    return mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name)


def make_mesh(data: Optional[int] = None, space: int = 1):
    """A (data, space) ``DeviceMesh`` over every rank of the process group;
    ``data`` defaults to world size // ``space``, as in the JAX package. Its
    device type is :func:`rank_device`'s."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if data is None:
        data = world // space
    if data * space != world:
        raise ValueError(f"a ({data}, {space}) mesh must span the world of {world} ranks")
    return init_device_mesh(rank_device().type, (data, space), mesh_dim_names=("data", "space"))


def replicate(mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's first
    rank, in place; returns the module."""
    src = int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=src)
    return module


def shard_batch(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``x``'s leading (batch) dim over ``data``."""
    n, i = _axis(mesh, "data")
    if x.shape[0] % n:
        raise ValueError(f"data={n} must divide the batch ({x.shape[0]})")
    step = x.shape[0] // n
    return x[i * step : (i + 1) * step]


def shard_spatial(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of an NHWC tensor: batch over ``data``, rows over
    ``space``."""
    x = shard_batch(mesh, x)
    n, i = _axis(mesh, "space")
    if x.shape[1] % n:
        raise ValueError(f"space={n} must divide the rows ({x.shape[1]})")
    step = x.shape[1] // n
    return x[:, i * step : (i + 1) * step].contiguous()


def gather(mesh, block: torch.Tensor) -> torch.Tensor:
    """The whole tensor from every rank's (data, space) block (dims 0 and
    1), on every rank: the counterpart of reading a sharded ``jax.Array``.
    Over gloo a CUDA block is gathered through host memory, a copy of the
    result."""
    staged = block.is_cuda and dist.get_backend() == "gloo"
    src = block.cpu() if staged else block.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    ranks = mesh.mesh.tolist()
    out = torch.cat([torch.cat([parts[r] for r in row], dim=1) for row in ranks], dim=0)
    return out.to(block.device) if staged else out


class _SumOver(torch.autograd.Function):
    """``all_reduce`` (sum) over a group, differentiable: the backward sums
    the gradient over the group too, since every rank's loss reads the sum.
    The counterpart of ``torch.distributed.nn.functional.all_reduce``, which
    torch deprecates (a warning at every call) for functional collectives
    that have no gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _SumOver.apply(g, ctx.group), None


def _spatial_band(mesh, model, image: torch.Tensor, lr_feats: torch.Tensor, out_hw):
    """This rank's (B/data, Ho/space, Wo, C) block of ``model(image,
    lr_feats, out_hw)`` on the fused path, with or without gradients: the
    body of :func:`naf_spatial_forward` and :func:`naf_spatial_train_step`.
    Raises where the band rules refuse (see :func:`naf_spatial_forward`)."""
    from naf_torch.kernels.encoder_fused import encoder_stack_band
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
    from naf_torch.models.naf import band_cells, band_encoder_rows
    from naf_torch.ops.resize import resize_bilinear

    oh, ow = int(out_hw[0]), int(out_hw[1])
    n_data, _ = _axis(mesh, "data")
    n_space, s = _axis(mesh, "space")
    hk, wk = lr_feats.shape[1], lr_feats.shape[2]
    if hk % n_space:
        raise ValueError(f"space={n_space} must divide the LR rows ({hk})")
    if image.shape[0] % n_data:
        raise ValueError(f"data={n_data} must divide the batch ({image.shape[0]})")
    if oh % hk:
        raise ValueError(f"a band needs whole cell rows: output rows {oh} % LR rows {hk} != 0")
    cells = band_cells(oh, hk, oh // n_space)
    ienc = model.image_encoder
    if not ienc.use_encoder:
        raise ValueError("the spatial forward needs the image encoder (use_encoder=True)")
    hi, wi = ienc.guard_size(image.shape[1], image.shape[2], oh, ow)
    eb = band_encoder_rows(oh, hk, cells, hi)
    image, feats = shard_batch(mesh, image), shard_batch(mesh, lr_feats).contiguous()
    if tuple(image.shape[1:3]) != (hi, wi):
        image = resize_bilinear(image, (hi, wi))
    image = image.contiguous()
    group = mesh.get_group("space")
    e0 = s * eb

    def sum_space(t):
        return _SumOver.apply(t, group)

    enc = torch.cat([encoder_stack_band(st, image, e0, e0 + eb, sum_space)
                     for st in (ienc.encoder, ienc.sem_encoder)], dim=-1)
    rope = ienc.rope
    keys = rope.pooled(enc, (oh, ow), (hk, wk), row0=e0, full_h=hi).float()
    keys = sum_space(keys).to(enc.dtype).contiguous()
    return naf_upsample_attention(
        enc, keys, feats, *rope.k2_tables(oh, ow), rope.d_head, num_heads=model.heads_attn,
        kernel_size=model.kernel_size, row_cell0=s * cells, band_cells=cells, enc_banded=True)


@torch.inference_mode()
def naf_spatial_forward(mesh, model, image: torch.Tensor, lr_feats: torch.Tensor, out_hw):
    """Spatially sharded NAF inference on the fused path: this rank's
    (B/data, Ho/space, Wo, C) block of ``model(image, lr_feats, out_hw)``,
    NHWC, as JAX's ``out_specs=P("data", "space")``. ``image`` (B, H, W, 3)
    and ``lr_feats`` (B, hk, wk, C) are the whole batch, the same on every
    rank.

    Each rank on ``space`` owns LR cell rows [s*hk/S, (s+1)*hk/S) and the
    encoder rows that band pools from: the image is guarded whole (3
    channels), both encoder stacks run on the rank's rows plus a halo with
    the GroupNorm statistics summed over ``space``
    (``encoder_fused.encoder_stack_band``),
    the pooled keys are this band's contribution (``RoPE.pooled`` with
    ``row0``), summed in f32 over ``space`` and cast once, and one banded K2
    call (``row_cell0``, ``band_cells``, ``enc_banded``, the whole RoPE
    tables) writes the band's output rows. On CUDA tensors every rank
    launches the stem kernel (twice), K1 (8 times) and K2 (once).

    Raises where ``space`` does not divide the LR rows or ``data`` the
    batch (as the JAX package does), and where the port's band rules refuse:
    whole cell rows (``band_cells``) and a band of whole encoder rows."""
    return _spatial_band(mesh, model, image, lr_feats, out_hw)


class _Band(torch.nn.Module):
    """``model`` as a submodule whose forward is this rank's band, so that
    ``functional_call`` can run the band on cast parameters."""

    def __init__(self, mesh, model):
        super().__init__()
        self.mesh, self.model = mesh, model

    def forward(self, image, lr_feats, out_hw):
        return _spatial_band(self.mesh, self.model, image, lr_feats, out_hw)


def naf_spatial_train_step(mesh, model, optimizer, use_bf16: bool):
    """Spatially sharded training: returns ``step(image, lr_feats, target,
    out_hw) -> loss``, one step of ``mean((model(image, lr_feats, out_hw) -
    target)**2)`` over the whole batch on a (data, space) mesh that updates
    the model's parameters and ``optimizer`` in place (the counterpart of
    the JAX dry run's jitted ``value_and_grad`` step, which GSPMD
    partitions). ``image`` (B, H, W, 3) and ``lr_feats`` (B, hk, wk, C) are
    the whole batch, as :func:`naf_spatial_forward` takes them; ``target``
    is this rank's (B/data, Ho/space, Wo, C) block (:func:`shard_spatial`).

    Each rank runs its band (:func:`naf_spatial_forward`'s computation) with
    gradients and takes its share of the loss: its sum of squares over the
    element count of its ``data`` shard's output. The GroupNorm statistics
    and the keys are summed over ``space`` by a differentiable
    ``all_reduce``, whose backward sums their gradients over ``space``, so
    every rank's backward sees the whole loss of its ``data`` shard through
    them. Each rank recomputes its halo rows from the image and keeps only
    its band, so no output row is counted twice: the sum over ``space`` of
    the ranks' parameter gradients is the gradient of the ``data`` shard's
    mean. One ``all_reduce`` of the flat f32 gradients and the loss shares
    over the whole world, divided by ``data``, gives every rank the
    gradient of the global mean; then the optimizer steps, so every rank
    holds the same parameters. The returned loss is the global mean, the
    same on every rank.

    On CUDA tensors every rank launches 8 K1 and one banded K2 in the
    forward, and in the backward one K3 (the K2 twin's recompute) and K4 in
    one or more bands of the rank's query rows. With ``use_bf16`` the
    parameters stay f32 masters, as in the trainer
    (``naf_torch.train.trainer``): the band runs on bf16 casts
    (``functional_call``) of them and of the inputs, and the gradients
    reach the masters through the casts.

    Raises on ``na_impl="xla"`` and, at the first step, where the band rules
    of :func:`naf_spatial_forward` refuse: it never falls back to a
    whole-grid forward on each rank."""
    from torch.func import functional_call

    from naf_torch.train.trainer import _cast_params, _sum_over

    if model.na_impl == "xla":
        raise ValueError('the spatial train step runs the fused path: na_impl="xla" has no '
                         "banded attention")
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    band = _Band(mesh, model)
    n_data, _ = _axis(mesh, "data")
    n_space, _ = _axis(mesh, "space")

    def step(image, lr_feats, target, out_hw):
        params = {f"model.{k}": p for k, p in _cast_params(model, dtype).items()}
        pred = functional_call(band, params, (image.to(dtype), lr_feats.to(dtype), out_hw))
        if pred.shape != target.shape:
            raise ValueError(f"target block {tuple(target.shape)} is not this rank's output "
                             f"block {tuple(pred.shape)}")
        share = (pred.float() - target.float()).square().sum() / (target.numel() * n_space)
        optimizer.zero_grad(set_to_none=True)
        share.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = share.detach().reshape(1).clone()
        _sum_over(None, [*(p.grad for p in model.parameters()), loss], n_data)
        optimizer.step()
        return loss[0]

    return step


def pjit_upsample(mesh, model):
    """Returns ``fn(image, lr_feats, out_hw)``: this rank's (data, space)
    block of ``model(image, lr_feats, out_hw)`` (NHWC, the whole batch in).
    On the fused path with ``space > 1`` that is :func:`naf_spatial_forward`;
    otherwise (``na_impl="xla"``, or ``space == 1``) the rank runs the whole
    forward of its batch shard and keeps its rows, which repeats the work of
    the other ranks on ``space``."""

    def fn(image, lr_feats, out_hw):
        n_space, s = _axis(mesh, "space")
        if model.na_impl != "xla" and n_space > 1:
            return naf_spatial_forward(mesh, model, image, lr_feats, out_hw)
        oh = int(out_hw[0])
        if oh % n_space:
            raise ValueError(f"space={n_space} must divide the output rows ({oh})")
        out = model(shard_batch(mesh, image), shard_batch(mesh, lr_feats),
                    (oh, int(out_hw[1])))
        step = oh // n_space
        return out[:, s * step : (s + 1) * step]

    return fn


def _rank_main(rank: int, fn, world: int, workdir: str, device):
    """One spawned rank of :func:`run_ranks`: torchrun's variables, the file
    rendezvous, ``fn(*args)`` on the arguments the parent saved, its result
    saved for the parent."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    args = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
    init_distributed(device, init_method=f"file://{os.path.join(workdir, 'rdzv')}")
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))


def run_ranks(fn, nprocs: int, args=(), device="cuda", timeout: float = 600.0,
              workdir: Optional[str] = None) -> list:
    """Run ``fn(*args)`` on ``nprocs`` spawned ranks that share one process
    group (file rendezvous under ``workdir``, a temporary directory by
    default; the device and backend of :func:`init_distributed`) and return
    the ranks' results in rank order. ``fn`` must be importable by name (a
    function of a module, not of a test file or ``__main__``). The arguments
    reach the ranks through a file, so the caller's tensors are not moved
    to shared memory as a spawn's arguments would be. A rank that raises or
    exits non-zero fails the call and ends the others; past ``timeout``
    seconds every rank is killed and the call raises."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        ctx = mp.start_processes(_rank_main, args=(fn, nprocs, tmp, device),
                                 nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.01)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__name__} did not finish in "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]
