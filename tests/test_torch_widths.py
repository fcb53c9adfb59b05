"""Widths of the reference's own configurations that the kernels take only
through zero padding, on the CPU against ``naf_tpu``:

- ``NAF(dim=96)`` (the denoising kernel-size ablation's width, hidden 48:
  K1's F = 48) against the JAX model, f32, atol = rtol = 2e-4; and K1's
  padding (F to a multiple of 64, C to one of 16, zero weights, scale =
  shift = 0) through the plain version, sliced back, against the unpadded
  plain version;
- NAF as a denoiser's attention (the 3-channel image as values: dv = 3 with
  one head, dv = 1 with three) through ``cross_scale_na2d_fused`` against
  ``naf_tpu.ops.na2d.cross_scale_na2d`` and its ``jax.vjp`` (2e-4 forward,
  2e-3 gradients); and K3/K4's channel padding through their plain
  versions, sliced back, against the unpadded ones.

On the card the wrappers pad the same way before they launch
(``tests/test_torch_card_na.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.convert import state_dict_from_jax_params
from naf_torch.kernels.encoder_fused import _pad_layer, gn_silu_conv_ref
from naf_torch.kernels.na2d_fused import (
    PAD,
    _pad_heads,
    cross_scale_na2d_fused,
    cross_scale_na2d_fused_bwd_ref,
    cross_scale_na2d_fused_ref,
)
from naf_torch.models.naf import NAF
from naf_tpu.models.naf import NAF as JNAF
from naf_tpu.ops.na2d import cross_scale_na2d as j_cross_scale_na2d

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
GTOL = dict(atol=2e-3, rtol=2e-3)


def _rand(seed, *shape, s=1.0):
    return (np.random.RandomState(seed).randn(*shape) * s).astype(np.float32)


@pytest.mark.parametrize("kernel_size", [9, 3])
def test_naf_dim96_matches_jax(kernel_size):
    kw = dict(dim=96, heads_attn=4, heads_rope=4, kernel_size=kernel_size)
    image, feats, out = _rand(0, 1, 32, 32, 3), _rand(1, 1, 16, 16, 64), (64, 64)
    jm = JNAF(na_impl="xla", **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(feats), out)["params"]
    model = NAF(**kw)
    model.load_state_dict(state_dict_from_jax_params(params, heads_rope=4))
    assert model.image_encoder.encoder[0].weight.shape[0] == 48  # K1's F
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(image), jnp.asarray(feats), out))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(image), torch.from_numpy(feats), out).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("c,f,k", [(48, 48, 3), (48, 48, 1), (40, 72, 3)])
def test_k1_padding_is_exact(c, f, k):
    """K1's wrapper pads F to 64 and C to 16 and slices y and the sums back:
    the same through the plain version equals the unpadded layer."""
    x = torch.from_numpy(_rand(2, 2, 9, 11, c))
    sc = torch.from_numpy(np.random.RandomState(3).rand(2, c).astype(np.float32) + 0.5)
    sh = torch.from_numpy(_rand(4, 2, c, s=0.1))
    w = torch.from_numpy(_rand(5, f, c, k, k, s=(c * k * k) ** -0.5))
    bias = torch.from_numpy(_rand(6, f, s=0.1))
    padded = _pad_layer(x, sc, sh, w, bias)
    assert padded[0].shape[-1] % 16 == 0 and padded[3].shape[0] % 64 == 0
    y, ps = gn_silu_conv_ref(*padded)
    y_ref, ps_ref = gn_silu_conv_ref(x, sc, sh, w, bias)
    torch.testing.assert_close(y[..., :f], y_ref, **TOL)
    torch.testing.assert_close(ps[..., :f], ps_ref, **TOL)
    assert not y[..., f:].any() and not ps[..., f:].any()  # the padded channels stay zero


# (heads, d, dv): the denoiser's values are the 3-channel image
DENOISER = [(1, 16, 3), (3, 8, 1)]


def _qkv(n, d, dv, hq=48, hk=12, seed=20):
    return (_rand(seed, 1, hq, hq, n, d), _rand(seed + 1, 1, hk, hk, n, d),
            _rand(seed + 2, 1, hk, hk, n, dv), _rand(seed + 3, 1, hq, hq, n, dv))


@pytest.mark.parametrize("n,d,dv", DENOISER)
def test_fused_na_at_denoiser_widths_matches_jax(n, d, dv):
    q, k, v, g = _qkv(n, d, dv)
    want, vjp = jax.vjp(lambda *a: j_cross_scale_na2d(*a, 5), jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    want_g = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = cross_scale_na2d_fused(*args, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for a, w in zip(torch.autograd.grad(got, args, torch.from_numpy(g)), want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GTOL)


@pytest.mark.parametrize("route", ["wgmma", "fma"])
@pytest.mark.parametrize("n,d,dv", DENOISER)
def test_fused_na_channel_padding_is_exact(n, d, dv, route):
    """The wrappers' zero channels, through the plain K3 and K4 and sliced
    back, equal the unpadded plain versions (the scale is the unpadded d's,
    as the wrapper passes it)."""
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(n, d, dv))
    mult, scale = PAD[route], d ** -0.5
    qp, kp, vp, gp = (_pad_heads(t, mult) for t in (q, k, v, g))
    assert qp.shape[-1] % mult == 0 and vp.shape[-1] % mult == 0 and vp.shape[-1] > dv
    out = cross_scale_na2d_fused_ref(qp, kp, vp, 5, scale)
    torch.testing.assert_close(out[..., :dv], cross_scale_na2d_fused_ref(q, k, v, 5, scale),
                               **TOL)
    assert not out[..., dv:].any()
    got = cross_scale_na2d_fused_bwd_ref(qp, kp, vp, gp, 5, scale)
    want = cross_scale_na2d_fused_bwd_ref(q, k, v, g, 5, scale)
    for a, w, c in zip(got, want, (d, d, dv)):
        torch.testing.assert_close(a[..., :c], w, **GTOL)
