"""The port's denoising slice (naf_torch.data.device_cache, evals.denoising,
models.restorers / restormer, the converters, train.denoise, the chunked
``train_upsampler`` route and ``python -m naf_torch.denoising``) against
naf_tpu, f32 on the CPU, from the same numpy inputs and the same noise.

Bars: metrics and losses at rtol 1e-5; the restorers and NAF as a denoiser
at atol = rtol = 2e-4; one denoiser step at rtol 1e-4 on the loss and
2e-4 on the parameters after AdamW; chunked training against the same steps
one by one, exactly (the same arithmetic in the same order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from naf_torch.convert import (
    ircnn_state_dict_from_jax,
    rednet_state_dict_from_jax,
    restormer_state_dict_from_jax,
    state_dict_from_jax_params,
)
from naf_torch.data.device_cache import device_cached_batches, device_cached_stack
from naf_torch.evals.denoising import DenoisingLoss, NoiseGenerator, psnr, ssim, ssim_loss
from naf_torch.models.naf import NAF
from naf_torch.models.restorers import IRCNN, REDNet, SameConvTranspose2d
from naf_torch.models.restormer import Restormer
from naf_torch.train.denoise import (
    DenoiseConfig,
    make_denoise_chunk,
    make_denoise_step,
    make_optimizer,
    train_denoiser,
)
from naf_torch.train.trainer import make_train_chunk, step_generator
from naf_tpu.data import device_cached_batches as j_device_cached_batches
from naf_tpu.evals import denoising as j_den
from naf_tpu.models.naf import NAF as JNAF
from naf_tpu.models.restorers import IRCNN as JIRCNN
from naf_tpu.models.restorers import REDNet as JREDNet
from naf_tpu.models.restormer import Restormer as JRestormer
from naf_tpu.train.denoise import _step_core as j_step_core

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
SMALL_NAF = dict(dim=32, heads_attn=1, heads_rope=1, kernel_size=5, img_layers=1)
RESTORMER = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


class _Dataset:
    """Image i is filled with the value i, so a batch shows its indices."""

    def __init__(self, n, hw=4):
        self.n, self.hw = n, hw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((self.hw, self.hw, 3), float(i), np.float32)}


def _indices(batch):
    return np.asarray(batch)[:, 0, 0, 0].astype(int).tolist()


@pytest.mark.parametrize("n,bs,shuffle", [(10, 3, True), (10, 5, False), (4, 9, True)])
def test_device_cached_batches_take_jax_order(n, bs, shuffle):
    ds = _Dataset(n)
    ours = device_cached_batches(ds, bs, shuffle=shuffle, seed=3, device="cpu")
    theirs = j_device_cached_batches(ds, bs, shuffle=shuffle, seed=3)
    for _ in range(7):
        assert _indices(next(ours)) == _indices(next(theirs))
    stack = device_cached_stack(ds, "cpu")
    assert stack.shape == (n, 4, 4, 3) and stack.dtype == torch.float32


def test_metrics_and_losses_match_jax():
    pred, target = _rand(1, 2, 24, 24, 3), _rand(2, 2, 24, 24, 3)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    for ours, theirs in ((psnr, j_den.psnr), (ssim, j_den.ssim), (ssim_loss, j_den.ssim_loss)):
        np.testing.assert_allclose(float(ours(tp, tt)), float(theirs(jp, jt)), rtol=1e-5)
    got = DenoisingLoss(1.0, 5.0, 0.2)(tp, tt)
    want = j_den.DenoisingLoss(1.0, 5.0, 0.2)(jp, jt)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)


def test_noise_generator_applies_its_draws_as_jax_does():
    """Given the same draws, the port's noise is the JAX package's formula:
    image + std * N(0, 1); salt where the mask holds, else the image."""
    img = torch.from_numpy(_rand(3, 2, 16, 16, 3))
    gen = torch.Generator().manual_seed(5)
    noisy = NoiseGenerator("gaussian")(gen, img, {"std": 0.3})
    draw = torch.randn(img.shape, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(noisy, img + draw * 0.3, rtol=0, atol=0)
    key = jax.random.PRNGKey(0)
    j_noisy = j_den.NoiseGenerator("gaussian")(key, jnp.asarray(img.numpy()), {"std": 0.3})
    j_draw = jax.random.normal(jax.random.split(key)[1], img.shape)
    np.testing.assert_allclose(np.asarray(j_noisy), img.numpy() + np.asarray(j_draw) * 0.3,
                               rtol=1e-6, atol=1e-6)
    sp = NoiseGenerator("salt_pepper")(torch.Generator().manual_seed(6), img, {"prob": 0.2})
    g2 = torch.Generator().manual_seed(6)
    mask, salt = torch.rand(img.shape, generator=g2) < 0.2, torch.rand(img.shape, generator=g2)
    torch.testing.assert_close(sp, torch.where(mask, (salt > 0.5).float(), img), rtol=0, atol=0)


def test_noise_statistics():
    img = torch.full((4, 64, 64, 3), 0.5)
    n = img.numel()
    noise = NoiseGenerator("gaussian")(torch.Generator().manual_seed(7), img, {"std": 0.2}) - img
    assert abs(float(noise.mean())) < 3 * 0.2 / n ** 0.5
    assert abs(float(noise.std()) - 0.2) < 3 * 0.2 / (2 * n) ** 0.5
    sp = NoiseGenerator("salt_pepper")(torch.Generator().manual_seed(8), img, {"prob": 0.1})
    share = float((sp != 0.5).float().mean())
    assert abs(share - 0.1) < 3 * (0.1 * 0.9 / n) ** 0.5
    salt = float((sp == 1.0).float().sum()) / float((sp != 0.5).float().sum())
    assert abs(salt - 0.5) < 3 * (0.25 / (0.1 * n)) ** 0.5
    for seed in range(5):
        rng_noise = NoiseGenerator("gaussian")(torch.Generator().manual_seed(seed), img,
                                               {"std": "range"}) - img
        assert 0.1 * 0.95 < float(rng_noise.std()) < 0.5 * 1.05
    with pytest.raises(ValueError, match="Unknown noise type"):
        NoiseGenerator("poisson")


def _restorer_pair(jmodel, model, convert, size, seed=9):
    x = _rand(seed, 1, size, size, 3)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(x),
                         (size, size))["params"]
    model.load_state_dict(convert(params))
    return x, params


def _check_restorer(jmodel, model, convert, size):
    x, params = _restorer_pair(jmodel, model, convert, size)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(x), (size, size))
    got = model(torch.from_numpy(x), torch.from_numpy(x), (size, size))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [16, 17])
def test_ircnn_matches_jax(size):
    _check_restorer(JIRCNN(nc=8), IRCNN(nc=8), ircnn_state_dict_from_jax, size)


def test_rednet_matches_jax_and_shares_its_odd_size_refusal():
    _check_restorer(JREDNet(num_layers=5, num_features=8), REDNet(num_layers=5, num_features=8),
                    rednet_state_dict_from_jax, 16)
    x = _rand(4, 1, 17, 17, 3)
    jm = JREDNet(num_layers=5, num_features=8)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(x), (17, 17))
    with pytest.raises(RuntimeError, match="size of tensor"):
        REDNet(num_layers=5, num_features=8)(torch.from_numpy(x), torch.from_numpy(x), (17, 17))


@pytest.mark.parametrize("n", [8, 9])
def test_same_transposed_conv_matches_flax_at_even_and_odd_sizes(n):
    x = _rand(10, 2, n, n, 5)
    layer = fnn.ConvTranspose(3, (3, 3), strides=(2, 2), padding="SAME")
    params = layer.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = layer.apply({"params": params}, jnp.asarray(x))
    ours = SameConvTranspose2d(5, 3, 3, stride=2)
    kernel = np.asarray(params["kernel"])
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(np.flip(kernel, (0, 1)).transpose(2, 3, 0, 1).copy()))
        ours.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 2 * n, 2 * n, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_restormer_matches_jax():
    jm = JRestormer(**RESTORMER)
    model = Restormer(**RESTORMER)
    x, params = _restorer_pair(jm, model, restormer_state_dict_from_jax, 32)
    # non-trivial norms and temperatures: the init leaves them at 1 and 0
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(len(path)), a.shape)
        if path[-1].key in ("weight", "bias", "temperature") else a, params)
    model.load_state_dict(restormer_state_dict_from_jax(params))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(x), (32, 32))
    got = model(torch.from_numpy(x), torch.from_numpy(x), (32, 32))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _naf_pair(size=32, seed=11):
    x = _rand(seed, 1, size, size, 3)
    jm = JNAF(**SMALL_NAF)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(x), (size, size))["params"]
    model = NAF(**SMALL_NAF)
    model.load_state_dict(state_dict_from_jax_params(params, img_layers=1, heads_rope=1))
    return jm, params, model


def test_naf_as_a_denoiser_matches_jax():
    """NAF with the noisy image as its 3-channel "features" at ratio 1: one
    head of d 32, k 5."""
    jm, params, model = _naf_pair()
    noisy = _rand(12, 2, 32, 32, 3)
    norm = (noisy - 0.45) / 0.225
    want = jm.apply({"params": params}, jnp.asarray(norm), jnp.asarray(noisy), (32, 32))
    got = model(torch.from_numpy(norm), torch.from_numpy(noisy), (32, 32))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _added(noise):
    """A noise generator of both packages' signature that adds ``noise``."""
    return lambda _gen, image, _params: image + noise


@pytest.mark.parametrize("name", ["naf", "ircnn"])
def test_denoiser_step_matches_jax_step_core(name):
    if name == "naf":
        jm, params, model = _naf_pair()
        convert = lambda p: state_dict_from_jax_params(p, img_layers=1, heads_rope=1)  # noqa: E731
    else:
        jm, model, convert = JIRCNN(nc=8), IRCNN(nc=8), ircnn_state_dict_from_jax
        x = _rand(13, 1, 32, 32, 3)
        params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(x), (32, 32))["params"]
        model.load_state_dict(convert(params))
    clean, noise = _rand(14, 2, 32, 32, 3), 0.3 * np.random.RandomState(15).randn(
        2, 32, 32, 3).astype(np.float32)
    cfg = DenoiseConfig(lr=1e-3, weight_decay=1e-4)
    tx = optax.adamw(cfg.lr, weight_decay=cfg.weight_decay)
    crit = (cfg.l1_weight, cfg.l2_weight, cfg.ssim_weight)
    new_params, _, j_loss = j_step_core(
        jm, tx, j_den.DenoisingLoss(*crit), _added(jnp.asarray(noise)), None, (32, 32),
        jnp.float32, params, tx.init(params), jnp.asarray(clean), jax.random.PRNGKey(0))
    step = make_denoise_step(model, make_optimizer(model, cfg), DenoisingLoss(*crit),
                             _added(torch.from_numpy(noise)), None, (32, 32), use_bf16=False)
    loss = step(torch.from_numpy(clean), torch.Generator())
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    got = model.state_dict()
    for key, want in convert(new_params).items():
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), err_msg=key, **TOL)


def test_restormer_gradient_through_checkpointed_blocks_matches_jax():
    """Under a gradient the port recomputes each transformer block in the
    backward, on the bf16 copies a trainer hands it; in f32 the gradient is
    JAX's."""
    jm, model = JRestormer(**RESTORMER), Restormer(**RESTORMER)
    x, params = _restorer_pair(jm, model, restormer_state_dict_from_jax, 16)
    target = _rand(19, 1, 16, 16, 3)

    def j_loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(x), (16, 16))
        return jnp.mean((out - target) ** 2)

    want = restormer_state_dict_from_jax(jax.grad(j_loss)(params))
    xt = torch.from_numpy(x)
    loss = ((model(xt, xt, (16, 16)) - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)
    # a forward under functional_call recomputes on the tensors it was given
    half = {k: p.detach().bfloat16().requires_grad_() for k, p in model.named_parameters()}
    out = torch.func.functional_call(model, half, (xt.bfloat16(), xt.bfloat16(), (16, 16)))
    grads = torch.autograd.grad(out.float().square().mean(), list(half.values()))
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in grads)


def _ircnn_trainer(seed=0):
    model = IRCNN(nc=8)
    cfg = DenoiseConfig(img_size=16, use_bf16=False, noise_params={"std": 0.3}, seed=seed)
    from naf_torch.api import _init_weights

    _init_weights(model, seed)
    step = make_denoise_step(model, make_optimizer(model, cfg), DenoisingLoss(1.0, 5.0, 0.2),
                             NoiseGenerator("gaussian"), cfg.noise_params, (16, 16), False)
    return model, step


def test_a_chunk_is_its_steps_one_by_one():
    stack = torch.from_numpy(_rand(16, 6, 16, 16, 3))
    idx = np.array([[0, 3], [5, 1], [2, 2]])
    model_a, step_a = _ircnn_trainer()
    losses = make_denoise_chunk(step_a, seed=0)(stack, idx, 4)
    model_b, step_b = _ircnn_trainer()
    singles = [step_b(stack[torch.from_numpy(i)], step_generator(0, 4 + k))
               for k, i in enumerate(idx)]
    torch.testing.assert_close(losses, torch.stack(singles), rtol=0, atol=0)
    for (name, a), b in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_train_denoiser_on_a_device_stack_logs_per_chunk(tmp_path):
    """5 steps at log_every 2: chunks of 2, 2 and 1 (tests/test_device_cache.py
    holds the JAX trainer to the same)."""
    stack = torch.from_numpy(_rand(17, 6, 16, 16, 3))
    cfg = DenoiseConfig(train_steps=5, img_size=16, use_bf16=False, log_every=2,
                        log_dir=str(tmp_path), noise_params={"std": 0.3})
    model = train_denoiser(IRCNN(nc=8), None, cfg, device_stack=stack, batch_size=2,
                           device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())
    logged = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in logged] == [1, 3, 4]
    with pytest.raises(ValueError, match="requires batch_size"):
        train_denoiser(IRCNN(nc=8), None, cfg, device_stack=stack, device="cpu")


def test_make_train_chunk_is_the_step_loop():
    """The upsampler's chunk calls its step once per row of indices, on the
    gathered, normalized batch, at the steps step0 + i."""
    calls = []

    def step(ups, back, step_idx, lr_size, out_hw, crop_hw):
        calls.append((ups.clone(), back.clone(), step_idx, lr_size, out_hw, crop_hw))
        return ups.mean() + back.mean()

    stack = torch.from_numpy(_rand(18, 5, 8, 8, 3))
    stats = (torch.tensor(0.4), torch.tensor(0.2)), (torch.tensor(0.5), torch.tensor(0.25))
    idx = np.array([[4, 0], [1, 1]])
    losses = make_train_chunk(step, *stats)(stack, idx, 7, (28, 28), (2, 2), (8, 8))
    assert [c[2] for c in calls] == [7, 8]
    for (ups, back, _, *rest), i, loss in zip(calls, idx, losses):
        img = stack[torch.from_numpy(i)]
        torch.testing.assert_close(ups, (img - 0.4) / 0.2)
        torch.testing.assert_close(back, (img - 0.5) / 0.25)
        assert rest == [(28, 28), (2, 2), (8, 8)]
        torch.testing.assert_close(loss, ups.mean() + back.mean())


def test_train_upsampler_on_a_device_stack_is_its_steps_one_by_one(tmp_path):
    """The chunked route of ``train_upsampler`` (3 steps at log_every 2: two
    chunks) takes the JAX package's batch order from RandomState(seed) and
    ends where the per-step route fed the same batches ends, exactly; it
    logs once per chunk and checkpoints at the end."""
    from naf_torch.backbones import PretrainedViTWrapper
    from naf_torch.data.device_cache import index_batches
    from naf_torch.train.trainer import TrainConfig, train_upsampler

    backbone = PretrainedViTWrapper("vit_small_patch14_dinov2.lvd142m", num_heads=2,
                                    embed_dim=64, depth=1, device="cpu")
    stack = _rand(20, 5, 112, 112, 3)
    kw = dict(train_steps=3, img_size=112, batch_size=2, use_bf16=False, ckpt_every=3,
              viz_every=0, lr=1e-3)
    naf = dict(dim=32, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=1)
    chunked = train_upsampler(NAF(**naf), backbone, None,
                              TrainConfig(**kw, log_every=2, log_dir=str(tmp_path / "c")),
                              device="cpu", device_stack=torch.from_numpy(stack))
    order = index_batches(5, 2, rng=np.random.RandomState(0))
    batches = iter([stack[next(order)] for _ in range(3)])
    stepped = train_upsampler(NAF(**naf), backbone, batches,
                              TrainConfig(**kw, log_every=1, log_dir=str(tmp_path / "s")),
                              device="cpu")
    for (name, a), b in zip(chunked.state_dict().items(), stepped.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    recs = [json.loads(line) for line in open(tmp_path / "c" / "version_0" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2] and all(r["lr_size"] == [56, 56] for r in recs)
    assert (tmp_path / "c" / "version_0" / "ckpt_3.pt").exists()


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    from naf_torch.denoising import main

    metrics = main(["synthetic=true", "device=cpu", "img_size=32", "train_steps=2", "val_steps=2",
                    "model.dim=32", "model.heads_attn=1", "model.heads_rope=1",
                    "model.kernel_size=5", "model.img_layers=1", f"run_dir={tmp_path}"])
    assert np.isfinite(metrics["psnr"]) and 0 < metrics["ssim"] <= 1
    assert len(open(tmp_path / "metrics.jsonl").read().splitlines()) == 1
    assert os.path.exists(tmp_path / "val_panel.png")
    assert "validation: PSNR" in capsys.readouterr().out
