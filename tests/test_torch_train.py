"""The port's training slice (naf_torch.backbones / train / utils / config /
data) against naf_tpu, f32 on CPU, from the same numpy inputs.

Bars: the ViT and the bicubic position resize at atol = rtol = 2e-4; two
train steps at rtol 1e-4 on the loss and atol 5e-4 / rtol 1e-3 on the
parameters (the bars of tests/test_train.py's data-parallel check).
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from naf_torch.backbones import PretrainedViTWrapper, ViT, ViTConfig, load_multiple_backbones
from naf_torch.backbones.vit import resize_bicubic_jax
from naf_torch.convert import state_dict_from_jax_params
from naf_torch.models.naf import NAF
from naf_torch.nn.rope import RopeDraws
from naf_torch.train.distill import round_to_nearest_multiple, sample_lr_size
from naf_torch.train.losses import Loss, mse_loss
from naf_torch.train.trainer import (
    TrainConfig,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    train_upsampler,
)
from naf_torch.utils.visualization import pca_rgb, plot_feats
from naf_tpu.backbones.convert import convert_timm_vit
from naf_tpu.backbones.vit import ViT as JViT
from naf_tpu.models.naf import NAF as JNAF
from naf_tpu.train import distill as j_distill
from naf_tpu.train import losses as j_losses
from naf_tpu.train.trainer import fold_step_key, make_train_step as j_make_train_step
from naf_tpu.utils import visualization as j_viz

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
SMALL_NAF = dict(dim=32, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=1, na_impl="xla")


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _small_vit(depth=2, dim=64, heads=2, seed=0):
    """A port ViT with non-trivial weights, and the JAX ViT with the same
    weights through the timm converter."""
    vit = ViT(ViTConfig(embed_dim=dim, depth=depth, num_heads=heads, pos_grid=37))
    vit.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in vit.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(seed + 1)) * 0.02)
    params, jcfg = convert_timm_vit(vit.state_dict(), heads)
    # convert_timm_vit infers a cls position from an odd token count, and
    # DINOv2's 1 + 37^2 = 1370 is even: state the layout instead.
    jcfg = dataclasses.replace(jcfg, use_cls_pos=True, pos_grid=37)
    return vit.eval(), JViT(jcfg), params


@pytest.mark.parametrize("n_in,n_out", [(37, 32), (37, 16), (16, 37)])
def test_bicubic_pos_resize_matches_jax_image_resize(n_in, n_out):
    x = _rand(0, 1, n_in, n_in, 24)
    want = jax.image.resize(jnp.asarray(x), (1, n_out, n_out, 24), "bicubic")
    got = resize_bicubic_jax(torch.from_numpy(x), (n_out, n_out))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [224, 112])
def test_vit_matches_jax_vit(size):
    vit, jvit, params = _small_vit()
    x = _rand(1, 2, size, size, 3)
    want = jvit.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = vit(torch.from_numpy(x))
    assert got.shape == (2, size // 14, size // 14, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vit_rejects_sizes_off_the_patch_grid():
    vit, _, _ = _small_vit(depth=1)
    with pytest.raises(ValueError, match="not divisible by patch"):
        vit(torch.zeros(1, 512, 512, 3))


def test_wrapper_loads_a_timm_state_dict_and_normalizes(tmp_path):
    vit, _, _ = _small_vit(depth=1)
    path = tmp_path / "vit.pth"
    torch.save(vit.state_dict(), path)
    wrap = PretrainedViTWrapper("vit_small_patch14_dinov2.lvd142m", checkpoint=str(path),
                                num_heads=2, device="cpu")
    assert (wrap.embed_dim, wrap.patch_size, wrap.vit_config.depth) == (64, 14, 1)
    x = torch.from_numpy(_rand(2, 1, 56, 56, 3))
    torch.testing.assert_close(wrap(x), vit(x))
    with pytest.raises(ValueError, match="come from the checkpoint"):
        PretrainedViTWrapper("vit_small_patch14_dinov2.lvd142m", checkpoint=str(path),
                             num_heads=2, depth=2, device="cpu")
    img01 = torch.rand(1, 4, 4, 3)
    want = (img01 - torch.tensor(wrap.config["mean"])) / torch.tensor(wrap.config["std"])
    torch.testing.assert_close(wrap.normalize(img01), want)
    random = load_multiple_backbones(
        {"name": ["vit_base_patch14_dinov2.lvd142m"] * 2, "checkpoint": None, "depth": 1},
        device="cpu")
    assert len(random) == 2 and random[0].embed_dim == 768
    assert random[0].vit_config.pos_grid == 37 and random[0].vit_config.num_heads == 12
    # every family resolves now: DINOv3 takes its RoPE, registers and no learned positions
    dinov3 = PretrainedViTWrapper("vit_base_patch16_dinov3.lvd1689m", device="cpu", depth=1,
                                  embed_dim=64, num_heads=2)
    assert (dinov3.vit_config.rope_theta, dinov3.vit_config.num_reg_tokens) == (100.0, 4)
    assert not hasattr(dinov3.model, "pos_embed")


def test_lr_sizes_and_losses_match_jax():
    assert round_to_nearest_multiple(100, 14) == j_distill.round_to_nearest_multiple(100, 14)
    for mode in ("fixed", "random"):
        ra, rb = np.random.RandomState(3), np.random.RandomState(3)
        for hw in ((448, 448), (512, 384)):
            assert sample_lr_size(hw, 14, mode, ra) == j_distill.sample_lr_size(hw, 14, mode, rb)
    with pytest.raises(ValueError):
        sample_lr_size((448, 448), 14, "other")
    p, t = _rand(4, 2, 4, 4, 8), _rand(5, 2, 4, 4, 8)
    for normalize in (False, True):
        want = float(j_losses.mse_loss(jnp.asarray(p), jnp.asarray(t), normalize=normalize))
        got = float(mse_loss(torch.from_numpy(p), torch.from_numpy(t), normalize=normalize))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(Loss("mse")(torch.ones(2, 2), torch.zeros(2, 2))["total"]) == 1.0
    with pytest.raises(NotImplementedError):
        Loss("l1")


def test_pca_panel_matches_jax():
    feats = [_rand(6, 8, 8, 16), _rand(7, 16, 16, 16)]
    for a, b in zip(pca_rgb(feats), j_viz.pca_rgb(feats)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    img = np.random.RandomState(8).rand(16, 16, 3).astype(np.float32)
    np.testing.assert_array_equal(plot_feats(img, feats), j_viz.plot_feats(img, feats))


def _jax_rescale(seed, step, bound=2.0):
    """The rescale draw JAX's train step makes for ``step``."""
    _, _, k_rescale = jax.random.split(fold_step_key(seed, step), 3)
    rmax = np.log(bound)
    return float(jnp.exp(jax.random.uniform(k_rescale, (1,), minval=-rmax, maxval=rmax))[0])


def _train_pair(img_size=224, batch=2):
    vit, jvit, vparams = _small_vit()
    jm = JNAF(**SMALL_NAF)
    feats = jnp.zeros((1, 8, 8, 64))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), feats, (16, 16))["params"]
    model = NAF(**SMALL_NAF)
    model.load_state_dict(state_dict_from_jax_params(params, img_layers=1, heads_rope=2))
    img = np.random.RandomState(9).rand(batch, img_size, img_size, 3).astype(np.float32)
    return vit, jvit, vparams, jm, params, model, img


def test_two_train_steps_match_jax_train_step():
    vit, jvit, vparams, jm, params, model, img = _train_pair()
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    opt_state = tx.init(params)
    j_step = j_make_train_step(jm, lambda x: jvit.apply({"params": vparams}, x), tx,
                               use_bf16=False, seed=0)
    cfg = TrainConfig(lr=1e-3, weight_decay=1e-4)
    opt = make_optimizer(model, cfg)
    step = make_train_step(model, vit, opt, use_bf16=False, seed=0)
    ups = (img - 0.45) / 0.225
    back = (img - 0.5) / 0.25
    kw = dict(lr_size=(112, 112), out_hw=(16, 16), crop_hw=(64, 64))
    for i in range(2):
        params, opt_state, j_loss = j_step(params, opt_state, jnp.asarray(ups),
                                           jnp.asarray(back), jnp.int32(i), **kw)
        loss = step(torch.from_numpy(ups), torch.from_numpy(back), i, **kw,
                    draws=RopeDraws(rescale=_jax_rescale(0, i)))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    want = state_dict_from_jax_params(params, img_layers=1, heads_rope=2)
    got = model.state_dict()
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)


def test_train_step_draws_its_augmentation_per_step():
    """Without given draws the step's augmentation comes from (seed, step):
    two steps differ, and the same step repeats."""
    vit, _, _, _, _, model, img = _train_pair(img_size=112, batch=1)
    x = torch.from_numpy(img)
    kw = dict(lr_size=(56, 56), out_hw=(8, 8), crop_hw=(32, 32))
    losses = []
    for i in (0, 1, 0):
        m = NAF(**SMALL_NAF)
        m.load_state_dict(model.state_dict())
        step = make_train_step(m, vit, make_optimizer(m, TrainConfig()), use_bf16=False)
        losses.append(float(step(x, x, i, **kw)))
    assert losses[0] != losses[1] and losses[0] == losses[2]


def _images(batch, size, seed=0):
    rng = np.random.RandomState(seed)
    while True:
        yield rng.rand(batch, size, size, 3).astype(np.float32)


def _tiny_backbone():
    return PretrainedViTWrapper("vit_small_patch14_dinov2.lvd142m", num_heads=2, embed_dim=64,
                                depth=1, device="cpu")


def test_train_smoke_writes_metrics_checkpoint_and_panel(tmp_path):
    cfg = TrainConfig(train_steps=6, img_size=112, batch_size=2, use_bf16=False, log_every=1,
                      log_dir=str(tmp_path), lr=1e-3)
    train_upsampler(NAF(**SMALL_NAF), _tiny_backbone(), _images(2, 112), cfg, device="cpu")
    run = tmp_path / "version_0"
    recs = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in recs] == list(range(6))
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert recs[-1]["loss"] < recs[0]["loss"] * 1.5  # moving, not diverging
    assert (run / "ckpt_6.pt").exists()
    assert glob.glob(str(run / "panel_step*.png"))


def test_resume_from_a_checkpoint_is_exact(tmp_path):
    def cfg(steps, name):
        return TrainConfig(train_steps=steps, img_size=112, batch_size=1, use_bf16=False,
                           log_every=1, ckpt_every=2, viz_every=0, lr=1e-3,
                           log_dir=str(tmp_path / name), down_factor="random")

    straight = train_upsampler(NAF(**SMALL_NAF), _tiny_backbone(), _images(1, 112),
                               cfg(4, "straight"), device="cpu")
    train_upsampler(NAF(**SMALL_NAF), _tiny_backbone(), _images(1, 112), cfg(2, "first"),
                    device="cpu")
    saved = load_checkpoint(str(tmp_path / "first" / "version_0" / "ckpt_2.pt"))
    assert saved["step"] == 2
    data = _images(1, 112)
    next(data), next(data)  # the batches the first run used
    resumed = train_upsampler(NAF(**SMALL_NAF), _tiny_backbone(), data, cfg(4, "resumed"),
                              params=saved["params"], opt_state=saved["opt_state"],
                              start_step=saved["step"], device="cpu")
    for (name, a), b in zip(straight.state_dict().items(), resumed.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    losses = [json.loads(line)["loss"]
              for line in open(tmp_path / "straight" / "version_0" / "metrics.jsonl")]
    resumed_losses = [json.loads(line)["loss"]
                      for line in open(tmp_path / "resumed" / "version_0" / "metrics.jsonl")]
    assert resumed_losses == losses[2:]


def test_cli_trains_in_process(tmp_path, capsys):
    from naf_torch.train.__main__ import main

    model = main(["synthetic=true", "device=cpu", "img_size=112", "train_steps=2",
                  "model.dim=32", "model.heads_attn=2", "model.heads_rope=2",
                  "model.kernel_size=5", "model.img_layers=1", "backbone.depth=1",
                  "backbone.embed_dim=64", "backbone.num_heads=2",
                  "train_dataloader.batch_size=1", f"run_dir={tmp_path}"])
    assert isinstance(model, NAF)
    run = tmp_path / "version_0"
    assert (run / "ckpt_2.pt").exists() and (run / "metrics.jsonl").exists()
    # resume from the port's checkpoint for one more step
    main(["synthetic=true", "device=cpu", "img_size=112", "train_steps=3", "model.dim=32",
          "model.heads_attn=2", "model.heads_rope=2", "model.kernel_size=5",
          "model.img_layers=1", "backbone.depth=1", "backbone.embed_dim=64",
          "backbone.num_heads=2", "train_dataloader.batch_size=1", f"run_dir={tmp_path}",
          f"model_ckpt={run / 'ckpt_2.pt'}"])
    assert (tmp_path / "version_1" / "ckpt_3.pt").exists()
    assert "loaded model checkpoint" in capsys.readouterr().out


def test_cli_keeps_the_reference_patch_size_error(tmp_path):
    """config/base.yaml's img_size 512 is not a multiple of DINOv2's patch
    14; the ViT raises, as the JAX package's does."""
    from naf_torch.train.__main__ import main

    with pytest.raises(ValueError, match="not divisible by patch"):
        main(["synthetic=true", "device=cpu", "train_steps=1", "model.dim=32",
              "model.heads_attn=2", "model.heads_rope=2", "model.kernel_size=5",
              "backbone.depth=1", "backbone.embed_dim=64", "train_dataloader.batch_size=1",
              f"run_dir={tmp_path}"])


def test_cli_folder_images_match_jax_data_path(tmp_path):
    """The CLI's real-data path (image folder, transforms, loader) yields the
    batches the JAX package's yields, and the config loader composes the
    same tree."""
    from PIL import Image

    from naf_torch.config import load_config
    from naf_torch.train.__main__ import folder_images
    from naf_tpu.config import load_config as j_load_config
    from naf_tpu.data import DataLoader as JLoader
    from naf_tpu.data import ImageFolderDataset as JFolder
    from naf_tpu.data.transforms import image_transform as j_transform

    rng = np.random.RandomState(13)
    for cls, (w, h) in (("a", (40, 30)), ("b", (28, 36)), ("b", (33, 33))):
        os.makedirs(tmp_path / "data" / cls, exist_ok=True)
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "data" / cls / f"{w}x{h}.png")
    overrides = [f"dataset.root={tmp_path / 'data'}", "img_size=28",
                 "train_dataloader.batch_size=2", "train_dataloader.num_workers=1",
                 "train_dataloader.shuffle=false"]
    cfg = load_config("base", overrides)
    assert cfg == {**j_load_config("base", overrides), "run_dir": cfg["run_dir"]}
    got = next(folder_images(cfg))
    ds = JFolder(str(tmp_path / "data"), transform=lambda im: j_transform(im, 28),
                 root_cache=str(tmp_path / "jax_cache"))
    want = next(iter(JLoader(ds, batch_size=2, shuffle=False, num_workers=1,
                             drop_last=True)))["image"]
    assert got.shape == (2, 28, 28, 3)
    np.testing.assert_array_equal(got, want)


def test_train_upsampler_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_upsampler(NAF(**SMALL_NAF), _tiny_backbone(), _images(1, 112),
                        TrainConfig(train_steps=1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the training path on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_train_step_matches_cpu_step(cuda_device):
    """One f32 step on the card (K1, K3, K4) against the same step on the
    CPU (plain code): loss at rtol 1e-3."""
    from naf_torch.api import _init_weights
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused

    torch.backends.cudnn.allow_tf32 = False
    vit, _, _ = _small_vit()
    src = NAF(dim=128, heads_attn=2, heads_rope=2, kernel_size=9)
    _init_weights(src, 0)
    x = torch.from_numpy(np.random.RandomState(9).rand(1, 224, 224, 3).astype(np.float32))
    kw = dict(lr_size=(112, 112), out_hw=(16, 16), crop_hw=(64, 64),
              draws=RopeDraws(rescale=1.3))
    losses = []
    launches = cross_scale_na2d_fused.launches, cross_scale_na2d_fused.bwd_launches
    for dev in ("cpu", cuda_device):
        m = NAF(dim=128, heads_attn=2, heads_rope=2, kernel_size=9)
        m.load_state_dict(src.state_dict())
        m.to(dev)
        step = make_train_step(m, vit.to(dev), make_optimizer(m, TrainConfig()), use_bf16=False)
        losses.append(float(step(x.to(dev), x.to(dev), 0, **kw)))
    assert (cross_scale_na2d_fused.launches, cross_scale_na2d_fused.bwd_launches) == (
        launches[0] + 1, launches[1] + 1)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-3)
