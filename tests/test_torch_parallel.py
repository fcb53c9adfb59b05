"""The port's data and spatial parallelism against naf_tpu, f32 on the CPU.

Ranks are gloo processes started by ``naf_torch.parallel.run_ranks`` (spawn,
a file rendezvous under ``tmp_path``, so parallel test workers never share a
port); the per-rank cases are ``naf_torch.dryrun.spatial_case`` and
``train_case``. Inputs are made with ``numpy.random.RandomState``; weights
go between the packages through the converters.

Bars: the sharded forward against JAX's ``model.apply`` and JAX's own
``naf_spatial_forward`` (interpret mode on the 8-device CPU mesh) at atol 2e-5
/ rtol 1e-5, the JAX package's bar for this path
(``tests/test_parallel_banded.py``); ``pjit_upsample`` on ``na_impl="xla"``
at atol 1e-5, as there. The two-rank data-parallel step against the
whole-batch step: gradients rel 1e-5 (per tensor, in the 2-norm); the loss
at rel 1e-6 against the port's one-process step and 1e-5 against JAX's (the
port's one-process loss is itself 2.2e-6 off JAX's here, where
``tests/test_torch_train.py`` holds it at 1e-4); parameters after two AdamW
steps at atol 1e-5 against the port's one-process step, and at the JAX
package's own data-parallel bar (atol 5e-4, rtol 1e-3,
``tests/test_train.py``) against JAX and between the CLI's runs: AdamW
moves every element by about lr * m / sqrt(v) whatever its gradient's size,
so an element whose gradients lie at rounding level moves by up to ~lr in
either run (two of the 256 elements of one weight do so in the CLI's).
"""

import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from naf_torch.convert import state_dict_from_jax_params
from naf_torch.dryrun import _model, spatial_case, train_case
from naf_torch.kernels import encoder_fused as ef
from naf_torch.nn.conv import Encoder
from naf_torch.parallel import naf_spatial_forward, run_ranks
from naf_torch.train.__main__ import build_mesh
from naf_torch.train.trainer import TrainConfig, train_upsampler
from naf_tpu.backbones.convert import convert_timm_vit
from naf_tpu.backbones.vit import ViT as JViT
from naf_tpu.convert import naf_params_from_torch
from naf_tpu.models.naf import NAF as JNAF
from naf_tpu.parallel import make_mesh as j_make_mesh
from naf_tpu.parallel import naf_spatial_forward as j_naf_spatial_forward
from naf_tpu.train.trainer import _upsampler_step_core, fold_step_key
from naf_tpu.train.trainer import make_train_step as j_make_train_step

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}

# (route, data, space, NAF kwargs, batch, image side, LR side, value channels, output side,
#  whether JAX's fused-q cell geometry takes the shape)
WIDE = dict(dim=128, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=2)
NARROW = dict(dim=32, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=2)
XLA = dict(dim=32, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=1, na_impl="xla")
SHARDED = {
    "spatial_1x2": ("spatial", 1, 2, WIDE, 1, 64, 16, 16, 64, True),
    "spatial_2x2": ("spatial", 2, 2, WIDE, 2, 48, 16, 16, 64, True),
    # no TPU cell block fits dim 32: JAX raises, the port's bands need none
    "spatial_1x2_narrow": ("spatial", 1, 2, NARROW, 1, 64, 16, 16, 64, False),
    "pjit_xla_2x2": ("pjit", 2, 2, XLA, 4, 64, 16, 32, 64, False),
}


@pytest.mark.parametrize("case", list(SHARDED))
def test_sharded_forward_matches_jax(case, tmp_path):
    route, data, space, naf, b, side, hk, cv, out, jax_sharded = SHARDED[case]
    rng = np.random.RandomState(0)
    img = rng.rand(b, side, side, 3).astype(np.float32)
    feats = rng.randn(b, hk, hk, cv).astype(np.float32)
    model = _model({"naf": naf, "seed": 0}, torch.device("cpu"), torch.float32)
    res = run_ranks(spatial_case, data * space, args=(dict(
        naf=naf, state=model.state_dict(), image=img, feats=feats, out_hw=(out, out),
        data=data, space=space, route=route, return_out=True),), device="cpu",
        timeout=180, workdir=str(tmp_path))
    assert [r["block"] for r in res] == [(b // data, out // space, out, cv)] * (data * space)
    assert all(r["gather_inverts_shard"] for r in res)
    got = res[0]["out"].numpy()
    params = naf_params_from_torch(model.state_dict(), img_layers=naf["img_layers"])
    want = JNAF(**naf).apply({"params": params}, jnp.asarray(img), jnp.asarray(feats),
                             (out, out))
    atol, rtol = (1e-5, 0.0) if route == "pjit" else (2e-5, 1e-5)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)
    if route == "pjit":  # and the port's own unsharded forward
        with torch.inference_mode():
            mine = model(torch.from_numpy(img), torch.from_numpy(feats), (out, out))
        np.testing.assert_allclose(got, mine.numpy(), atol=1e-5, rtol=0)
    if jax_sharded:
        sharded = j_naf_spatial_forward(
            j_make_mesh(data=data, space=space), JNAF(**naf, na_impl="fused_q"), params, img,
            feats, (out, out), interpret=True)
        np.testing.assert_allclose(got, np.asarray(sharded), atol=2e-5, rtol=1e-5)


def _fake_mesh(data, space):
    """The mesh attributes the spatial forward reads before any collective."""
    return types.SimpleNamespace(mesh_dim_names=("data", "space"),
                                 size=lambda i: (data, space)[i], get_local_rank=lambda n: 0)


@pytest.mark.parametrize("batch,side,hk,out,match", [
    (1, 64, 15, 60, "space=2 must divide the LR rows"),
    (3, 64, 16, 64, "data=2 .* the batch"),
    (2, 64, 16, 60, "whole cell rows"),
    (2, 33, 16, 64, "no whole encoder rows"),
])
def test_spatial_forward_raises_where_the_band_rules_refuse(batch, side, hk, out, match):
    model = _model({"naf": NARROW, "seed": 0}, torch.device("cpu"), torch.float32)
    with pytest.raises(ValueError, match=match):
        naf_spatial_forward(_fake_mesh(2, 2), model, torch.zeros(batch, side, side, 3),
                            torch.zeros(batch, hk, hk, 16), (out, out))


SMALL_NAF = dict(dim=32, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=1, na_impl="xla")
VIT = dict(embed_dim=64, depth=2, num_heads=2, pos_grid=37)
STEP = dict(lr_size=(112, 112), out_hw=(16, 16), crop_hw=(64, 64))


def _jax_rescale(seed, step, bound=2.0):
    """The rescale draw JAX's train step makes for ``step``."""
    _, _, k_rescale = jax.random.split(fold_step_key(seed, step), 3)
    rmax = np.log(bound)
    return float(jnp.exp(jax.random.uniform(k_rescale, (1,), minval=-rmax, maxval=rmax))[0])


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Two gloo ranks take two data-parallel steps from JAX-initialised
    weights (rank 0 also the one-process steps on the whole batch); JAX takes
    the same steps on the whole batch, and its first step's gradients."""
    from naf_torch.backbones import ViT, ViTConfig

    vit = ViT(ViTConfig(**VIT))
    vit.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in vit.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.02)
    vparams, jcfg = convert_timm_vit(vit.state_dict(), VIT["num_heads"])
    # DINOv2's 1 + 37^2 position table is even: state the cls position
    jvit = JViT(dataclasses.replace(jcfg, use_cls_pos=True, pos_grid=37))
    jm = JNAF(**SMALL_NAF)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 8, 8, 64)),
                     (16, 16))["params"]
    state = state_dict_from_jax_params(params, img_layers=1, heads_rope=2)
    img = np.random.RandomState(9).rand(2, 224, 224, 3).astype(np.float32)
    ups, back = (img - 0.45) / 0.225, (img - 0.5) / 0.25
    draws = [{"rescale": _jax_rescale(0, i)} for i in range(2)]
    res = run_ranks(train_case, 2, args=(dict(
        naf=SMALL_NAF, state=state, backbone_state=vit.state_dict(), backbone_config=VIT,
        ups=ups, back=back, steps=2, use_bf16=False, lr=1e-3, weight_decay=1e-4, draws=draws,
        one_process=True, **STEP),), device="cpu", timeout=180,
        workdir=str(tmp_path_factory.mktemp("dp")))

    backbone = lambda x: jvit.apply({"params": vparams}, x)  # noqa: E731
    capture = optax.GradientTransformation(  # its state after a step is the gradient
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    _, grads, _ = _upsampler_step_core(jm, backbone, capture, False, False, 0, params,
                                       capture.init(params), jnp.asarray(ups),
                                       jnp.asarray(back), jnp.int32(0), **STEP)
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    j_step = j_make_train_step(jm, backbone, tx, use_bf16=False, seed=0)
    p, opt_state, losses = params, tx.init(params), []
    for i in range(2):
        p, opt_state, loss = j_step(p, opt_state, jnp.asarray(ups), jnp.asarray(back),
                                    jnp.int32(i), **STEP)
        losses.append(float(loss))
    jax_ref = {"losses": losses,
               "grads": state_dict_from_jax_params(grads, img_layers=1, heads_rope=2),
               "params": state_dict_from_jax_params(p, img_layers=1, heads_rope=2)}
    return res, jax_ref


# loss rtol, and the parameters after the steps (atol, rtol); see the module
# docstring
LOSS_BAR = {"jax": 1e-5, "one_process": 1e-6}
PARAM_BAR = {"jax": (5e-4, 1e-3), "one_process": (1e-5, 0.0)}


@pytest.mark.parametrize("reference", ["jax", "one_process"])
def test_data_parallel_step_matches_the_whole_batch_step(dp_run, reference):
    res, jax_ref = dp_run
    ref = jax_ref if reference == "jax" else res[0]["single"]
    atol, rtol = PARAM_BAR[reference]
    for r in res:  # every rank holds the same step
        np.testing.assert_allclose(r["dp"]["losses"], ref["losses"], rtol=LOSS_BAR[reference])
        for name, g in r["dp"]["grads"].items():
            want = ref["grads"][name].float()
            rel = float((g - want).norm() / want.norm().clamp_min(1e-30))
            assert rel <= 1e-5, (name, rel)
        for name, want in ref["params"].items():
            if name in r["dp"]["params"]:
                np.testing.assert_allclose(r["dp"]["params"][name].numpy(),
                                           want.float().numpy(), atol=atol, rtol=rtol,
                                           err_msg=name)


def test_build_mesh_rules(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert build_mesh("auto", 4, "cpu") is None  # one rank
    assert build_mesh("none", 4, "cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert build_mesh("auto", 4, "cpu") is None  # an uneven batch falls back to one rank
    with pytest.raises(ValueError, match="batch_size % ranks"):
        build_mesh("data", 4, "cpu")
    with pytest.raises(ValueError, match="auto, data or none"):
        build_mesh("space", 4, "cpu")


def test_device_stack_with_a_mesh_raises():
    from naf_torch.backbones import PretrainedViTWrapper
    from naf_torch.models.naf import NAF

    backbone = PretrainedViTWrapper("vit_small_patch14_dinov2.lvd142m", num_heads=2,
                                    embed_dim=64, depth=1, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_upsampler(NAF(**SMALL_NAF), backbone, None, TrainConfig(train_steps=1),
                        device="cpu", device_stack=torch.zeros(2, 112, 112, 3),
                        mesh=object())


CLI = ["synthetic=true", "device=cpu", "img_size=112", "train_steps=2", "model.dim=32",
       "model.heads_attn=2", "model.heads_rope=2", "model.kernel_size=5",
       "backbone.depth=1", "backbone.embed_dim=64", "backbone.num_heads=2",
       "train_dataloader.batch_size=2"]


def test_torchrun_cli_trains_data_parallel(tmp_path):
    """``torchrun --nproc_per_node 2 -m naf_torch.train mesh=data``: one run
    directory, written by rank 0, with the losses and final weights of
    ``mesh=none`` in one process."""
    from naf_torch.train.__main__ import main
    from naf_torch.train.trainer import load_checkpoint

    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "naf_torch.train", "mesh=data", *CLI, f"run_dir={tmp_path / 'dp'}"],
        env=ENV, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("data-parallel mesh over 2 ranks") == 2
    assert sorted(os.listdir(tmp_path / "dp")) == ["version_0"]
    main(["mesh=none", *CLI, f"run_dir={tmp_path / 'one'}"])
    runs = [tmp_path / name / "version_0" for name in ("dp", "one")]
    losses = [[json.loads(line)["loss"] for line in open(r / "metrics.jsonl")] for r in runs]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    dp, one = (load_checkpoint(str(r / "ckpt_2.pt"))["params"] for r in runs)
    for name, want in one.items():
        np.testing.assert_allclose(dp[name].numpy(), want.numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)
    assert glob.glob(str(runs[0] / "panel_step*.png"))


def test_dryrun_cli_on_four_cpu_ranks():
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "naf_torch.dryrun", "--ranks", "4",
                           "--device", "cpu", "--timeout", "180"],
                          env=ENV, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "DRYRUN_OK" in proc.stdout
    assert "spatial mesh (2, 2), gathered output (2, 128, 256, 384)" in proc.stdout
    spatial = re.search(r"spatial train step on mesh \(2, 2\): loss (\S+) on every rank",
                        proc.stdout)
    assert spatial and np.isfinite(float(spatial.group(1)))
    assert time.monotonic() - t0 < 240


@pytest.mark.parametrize("fn,args,error", [
    (time.sleep, (120,), TimeoutError),  # a hung rank: every rank is killed at the limit
    (np.sqrt, ("not a number",), Exception),  # a rank that raises fails the call
])
def test_a_failed_rank_fails_the_call_in_time(fn, args, error, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(error):
        run_ranks(fn, 2, args=args, device="cpu", timeout=6, workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encoder_twin_keeps_bf16_widenings_as_bf16_with_the_same_gradients(dtype):
    """The denoiser's peak: the encoder twin's f32 widenings of bf16
    activations are saved as bf16. Every packed tensor holds only bf16
    values, the gradients are bitwise those of the unpacked twin, and in
    bf16 the packed tensors are at least 30% of what the recompute saves."""
    torch.manual_seed(0)
    pix = Encoder(32, kernel_size=1, ks_res=1, num_layers=2)
    sem = Encoder(32, kernel_size=3, ks_res=3, num_layers=2)
    specs = (ef._stack_spec(pix), ef._stack_spec(sem))
    params = [p.detach().to(dtype) for p in ef._stack_params(pix) + ef._stack_params(sem)]
    saved = [torch.randn(2, 96, 96, 3).to(dtype), *params]
    g = torch.randn(2, 96, 96, 64).to(dtype)
    needs = (False,) + (True,) * len(params)  # the denoiser's image needs no gradient
    sizes = {True: 0, False: 0}

    def pack(t):
        packed = ef._pack_exact_bf16(t)
        if packed[1]:
            assert torch.equal(packed[0].float(), t)
        sizes[packed[1]] += t.numel() * t.element_size()
        return packed

    old = ef._PACK_MIN
    ef._PACK_MIN = 1 << 10
    try:
        got = ef._twin_grads(saved, needs, specs, g)
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                pack, ef._unpack_exact_bf16):
            ef._stacks_ref(inputs[0], inputs[1:], specs)
    finally:
        ef._PACK_MIN = old
    with torch.enable_grad():
        out = ef._stacks_ref(inputs[0], inputs[1:], specs)
    want = ef._grads((out,), (g,), inputs)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))
    if dtype == torch.bfloat16:
        assert sizes[True] >= 0.3 * (sizes[True] + sizes[False])
    else:
        assert sizes[True] == 0
