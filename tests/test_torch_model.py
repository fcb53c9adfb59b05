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
    model = NAF(**SMALL)
    x, f = torch.zeros(1, 32, 32, 3), torch.zeros(1, 16, 16, 64)
    with pytest.raises(NotImplementedError, match="streamed"):
        model(x, f, (32, 32), band_rows=8)
    with pytest.raises(NotImplementedError, match="training"):
        model(x, f, (32, 32), train=True)


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
