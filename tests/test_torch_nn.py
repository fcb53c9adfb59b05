"""naf_torch.nn against naf_tpu.nn (flax), f32 on CPU, atol = rtol = 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.convert import encoder_state_dict_from_jax
from naf_torch.nn import CrossScaleAttention, Encoder, RoPE, rotate_half
from naf_tpu.nn import CrossScaleAttention as JCrossScaleAttention
from naf_tpu.nn import Encoder as JEncoder
from naf_tpu.nn import RoPE as JRoPE

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("ks", [1, 3])
def test_encoder_matches_flax(ks):
    x = _rand(0, 2, 12, 10, 3)
    jenc = JEncoder(64, kernel_size=ks, ks_res=ks, num_layers=2)
    params = jenc.init(jax.random.PRNGKey(ks), jnp.asarray(x))["params"]
    # non-trivial GroupNorm affine, so the names are checked too
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), params)
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    enc = Encoder(64, kernel_size=ks, ks_res=ks, num_layers=2)
    enc.load_state_dict(encoder_state_dict_from_jax(params, 2))
    got = enc(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _ropes(c=64, heads=2):
    jr = JRoPE(embed_dim=c, num_heads=heads)
    return jr, jr.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, c))), RoPE(c, heads)


@pytest.mark.parametrize("h,w", [(6, 10), (16, 16)])
def test_rope_tables_and_apply_match_flax(h, w):
    jr, jp, rope = _ropes()
    want = jr.apply(jp, h, w, method=jr.tables)
    for got, ref in zip(rope.tables(h, w), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    x = _rand(2, 1, h, w, 64)
    np.testing.assert_allclose(rope(torch.from_numpy(x)).numpy(),
                               np.asarray(jr.apply(jp, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("hi,up,down", [
    ((16, 16), (16, 16), (4, 4)),   # identity branch
    ((8, 12), (16, 24), (4, 6)),    # separable pool-up collapse
    ((6, 5), (20, 16), (7, 4)),     # ragged pools
])
def test_rope_pooled_matches_flax(hi, up, down):
    jr, jp, rope = _ropes()
    x = _rand(3, 1, *hi, 64)
    want = jr.apply(jp, jnp.asarray(x), up_hw=up, down_hw=down, method=jr.pooled)
    got = rope.pooled(torch.from_numpy(x), up, down)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rotate_half_is_the_rotate_matrix():
    _, _, rope = _ropes(c=128, heads=4)
    x = torch.from_numpy(_rand(4, 3, 128))
    torch.testing.assert_close(rotate_half(x, 32), x @ rope.rotate_matrix())


def test_rope_periods_stay_float32_across_casts():
    rope = RoPE(256, 4)
    before = rope.periods.clone()
    rope.to(torch.bfloat16)
    assert rope.periods.dtype == torch.float32
    torch.testing.assert_close(rope.periods, before)


@pytest.mark.parametrize("hq,hk,k", [(32, 8, 5), (30, 7, 3)])
def test_cross_scale_attention_matches_flax(hq, hk, k):
    n, c, cv = 2, 16, 12
    q, kk, v = _rand(5, 1, hq, hq, c), _rand(6, 1, hk, hk, c), _rand(7, 1, hk, hk, cv)
    jat = JCrossScaleAttention(dim=c, num_heads=n, kernel_size=k, impl="xla")
    want, ww = jat.apply({}, jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v),
                         return_weights=True)
    att = CrossScaleAttention(c, n, k)
    got, w = att(torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(v),
                 return_weights=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ww), **TOL)
    np.testing.assert_allclose(
        att(torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(v)).numpy(),
        np.asarray(want), **TOL)


def test_cross_scale_attention_pallas_impl_raises():
    att = CrossScaleAttention(16, 2, 3, impl="pallas")
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(NotImplementedError, match="training slice"):
        att(x, x[:, :4, :4], x[:, :4, :4])
