"""The whole port (naf_torch NAF, weights, API) against naf_tpu, f32 on CPU.

The port's NAF on CPU tensors runs the fused inference path through the
kernels' plain versions; it is held against naf_tpu's NAF(na_impl="xla"),
whose modular path the JAX package proves equal to its fused-q kernel
(tests/test_kernel_fused_q.py). Bars: atol = rtol = 2e-4 and cosine > 0.999.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch import NAFUpsampler, load_naf_params, naf
from naf_torch.convert import state_dict_from_jax_params
from naf_torch.models.naf import NAF
from naf_tpu.convert import naf_params_from_torch
from naf_tpu.models.naf import NAF as JNAF

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(dim=128, heads_attn=2, heads_rope=2, kernel_size=9)
FULL_WIDTH = dict(dim=256, heads_attn=4, heads_rope=4, kernel_size=9)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(kw, image, feats, out):
    jm = JNAF(na_impl="xla", **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(feats), out)["params"]
    model = NAF(**kw)
    model.load_state_dict(state_dict_from_jax_params(params, heads_rope=kw["heads_rope"]))
    return jm, params, model.eval()


def _cos(a, b):
    return float(np.vdot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("kw,img,feat,out", [
    (SMALL, (32, 32), (16, 16, 64), (64, 64)),
    (FULL_WIDTH, (96, 96), (12, 12, 384), (96, 96)),
    (SMALL, (100, 24), (12, 12, 64), (24, 24)),   # input guard (bilinear downscale)
], ids=["small", "full_width", "guard"])
def test_naf_matches_jax(kw, img, feat, out):
    image, feats = _rand(0, 1, *img, 3), _rand(1, 1, *feat)
    jm, params, model = _pair(kw, image, feats, out)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(image), jnp.asarray(feats), out))
    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(feats), out).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert _cos(got, want) > 0.999


def test_modular_path_returns_the_scores_jax_returns():
    image, feats, out = _rand(2, 1, 32, 32, 3), _rand(3, 1, 16, 16, 64), (64, 64)
    jm, params, model = _pair(SMALL, image, feats, out)
    want, ww = jm.apply({"params": params}, jnp.asarray(image), jnp.asarray(feats), out,
                        return_weights=True)
    with torch.no_grad():
        got, w = model(torch.from_numpy(image), torch.from_numpy(feats), out,
                       return_weights=True)
        fused = model(torch.from_numpy(image), torch.from_numpy(feats), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ww), **TOL)
    np.testing.assert_allclose(fused.numpy(), got.numpy(), **TOL)


def test_weights_round_trip_through_the_jax_converter():
    image, feats = _rand(4, 1, 32, 32, 3), _rand(5, 1, 16, 16, 64)
    _, params, model = _pair(SMALL, image, feats, (32, 32))
    back = naf_params_from_torch(model.state_dict(), img_layers=2, rope_base=100.0, strict=True)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path({"image_encoder": params["image_encoder"]}))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))


def test_load_naf_params_reads_a_reference_checkpoint(tmp_path):
    src = load_naf_params(seed=3, device="cpu", **SMALL)
    state = {k: v.clone() for k, v in src.state_dict().items()}
    plain, nested = tmp_path / "naf.pth", tmp_path / "nested.pth"
    torch.save(state, plain)
    torch.save({"state_dict": state}, nested)
    for path in (plain, nested):
        model = load_naf_params(str(path), device="cpu", **SMALL)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, state[k])
    other = load_naf_params(seed=4, device="cpu", **SMALL)
    assert not torch.equal(other.image_encoder.encoder[0].weight, src.image_encoder.encoder[0].weight)


def test_api_layouts_and_upsampler():
    model = load_naf_params(seed=0, device="cpu", **SMALL)
    image, feats = _rand(6, 1, 3, 32, 32), _rand(7, 1, 64, 16, 16)
    nchw = naf(model, image, feats, (48, 48))
    assert nchw.shape == (1, 64, 48, 48)
    nhwc = naf(model, torch.from_numpy(image).permute(0, 2, 3, 1),
               torch.from_numpy(feats).permute(0, 2, 3, 1), (48, 48), channels_last=True)
    torch.testing.assert_close(nchw.permute(0, 2, 3, 1), nhwc)
    ups = NAFUpsampler(model)
    torch.testing.assert_close(ups(image, feats, (48, 48)), nchw.detach())


def test_bf16_model_keeps_f32_periods_and_runs():
    model = load_naf_params(seed=0, device="cpu", dtype=torch.bfloat16, **SMALL)
    rope = model.image_encoder.rope
    assert rope.periods.dtype == torch.float32
    torch.testing.assert_close(rope.periods, NAF(**SMALL).image_encoder.rope.periods)
    out = NAFUpsampler(model)(_rand(8, 1, 3, 32, 32), _rand(9, 1, 64, 16, 16), (32, 32))
    assert out.dtype == torch.bfloat16 and bool(out.isfinite().all())


def test_later_slices_raise():
    """Streamed outputs are a later slice; training is this one, and the
    JAX package ignores band_rows when training."""
    model = NAF(**SMALL)
    x, f = torch.zeros(1, 32, 32, 3), torch.zeros(1, 16, 16, 64)
    with pytest.raises(NotImplementedError, match="streamed"):
        model(x, f, (32, 32), band_rows=8)
    out = model(x, f, (32, 32), train=True, band_rows=8)
    assert out.shape == (1, 32, 32, 64)
    with pytest.raises(ValueError, match="na_impl"):
        NAF(na_impl="other")


@pytest.mark.parametrize("na_impl", ["xla", "pallas"])
def test_train_forward_matches_jax(na_impl):
    """NAF(train=True) with a given rescale draw against the JAX model fed
    the same draw through its rng (modular path; "pallas" runs the fused NA
    wrapper's plain version here)."""
    image, feats, out = _rand(10, 1, 32, 32, 3), _rand(11, 1, 16, 16, 64), (32, 32)
    jm, params, _ = _pair(SMALL, image, feats, out)
    model = NAF(**SMALL, na_impl=na_impl)
    model.load_state_dict(state_dict_from_jax_params(params, heads_rope=SMALL["heads_rope"]))
    key = jax.random.PRNGKey(7)
    want = jm.apply({"params": params}, jnp.asarray(image), jnp.asarray(feats), out,
                    train=True, rng=key)
    _, _, kr = jax.random.split(key, 3)
    rm = np.log(2.0)
    rescale = float(jnp.exp(jax.random.uniform(kr, (1,), minval=-rm, maxval=rm))[0])
    from naf_torch.nn.rope import RopeDraws

    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(feats), out, train=True,
                    draws=RopeDraws(rescale=rescale))
        plain = model(torch.from_numpy(image), torch.from_numpy(feats), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-3)  # the draw mattered


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
def test_naf_without_encoder_matches_jax(train):
    """use_encoder=False passes the input, of `dim` channels, straight to the
    pool and RoPE, as the JAX model does (inference on the fused path, and
    training on the modular one)."""
    kw = dict(dim=16, heads_attn=2, heads_rope=2, kernel_size=5, use_encoder=False)
    image, feats, out = _rand(12, 1, 16, 16, 16), _rand(13, 1, 8, 8, 24), (16, 16)
    jm = JNAF(na_impl="xla", **kw)
    key = jax.random.PRNGKey(3)
    want = jm.apply({}, jnp.asarray(image), jnp.asarray(feats), out, train=train, rng=key)
    _, _, kr = jax.random.split(key, 3)
    rm = np.log(2.0)
    rescale = float(jnp.exp(jax.random.uniform(kr, (1,), minval=-rm, maxval=rm))[0])
    from naf_torch.nn.rope import RopeDraws

    model = NAF(**kw).eval()
    assert not any(True for _ in model.parameters())
    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(feats), out, train=train,
                    draws=RopeDraws(rescale=rescale) if train else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_naf_params(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NAFUpsampler(**SMALL)


def test_port_imports_nothing_of_jax():
    """Every module of naf_torch, and chip_smoke.py, import without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import chip_smoke, naf_torch, naf_torch.api\n"
        "for m in pkgutil.walk_packages(naf_torch.__path__, 'naf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'naf_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('naf_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
