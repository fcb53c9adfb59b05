"""naf_torch.nn against naf_tpu.nn (flax), f32 on CPU, atol = rtol = 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.convert import encoder_state_dict_from_jax
from naf_torch.nn import CrossScaleAttention, Encoder, RoPE, rotate_half
from naf_torch.nn.rope import RopeDraws
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


def test_residual_encoder_without_bias_matches_flax():
    """JAFAR's stacks: residual blocks, convs without biases."""
    x = _rand(2, 1, 10, 12, 3)
    jenc = JEncoder(32, kernel_size=1, ks_res=1, num_layers=2, use_bias=False, residual=True)
    params = jenc.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    enc = Encoder(32, kernel_size=1, ks_res=1, num_layers=2, bias=False, residual=True)
    enc.load_state_dict(encoder_state_dict_from_jax(params, 2))
    np.testing.assert_allclose(enc(torch.from_numpy(x)).detach().numpy(), want, **TOL)


def test_enc_block_conv_shortcut_matches_flax():
    from naf_torch.nn import EncBlock
    from naf_tpu.nn.conv import EncBlock as JEncBlock

    x = _rand(3, 1, 9, 11, 16)
    jblk = JEncBlock(16, 16, kernel_size=3, use_conv_shortcut=True, residual=True)
    params = jblk.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    rng = np.random.RandomState(6)
    params = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), params)
    want = np.asarray(jblk.apply({"params": params}, jnp.asarray(x)))
    blk = EncBlock(16, 3, residual=True, conv_shortcut=True)
    state = encoder_state_dict_from_jax({"stem": params["conv1"], "block0": params}, 1)
    blk.load_state_dict({k[2:]: v for k, v in state.items() if k.startswith("1.")})
    np.testing.assert_allclose(blk(torch.from_numpy(x)).detach().numpy(), want, **TOL)


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
    """impl="pallas" runs the fused NA wrapper: on CPU tensors its plain
    version (equal to the oracle), on a tensor on neither CPU nor CUDA it
    raises rather than fall back."""
    att = CrossScaleAttention(16, 2, 3, impl="pallas")
    q, k, v = _rand(8, 1, 16, 16, 16), _rand(9, 1, 8, 8, 16), _rand(10, 1, 8, 8, 8)
    got = att(*(torch.from_numpy(a) for a in (q, k, v)))
    want = CrossScaleAttention(16, 2, 3, impl="xla")(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    x = torch.zeros(1, 8, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        att(x, x[:, :4, :4], x[:, :4, :4])


def _jax_draws(seed, shift, jitter, rescale):
    """The draws JAX's RoPE._augment_axes makes from PRNGKey(seed)."""
    import math

    ks, kj, kr = jax.random.split(jax.random.PRNGKey(seed), 3)
    sh = jax.random.uniform(ks, (2,), minval=-shift, maxval=shift)
    jm, rm = math.log(jitter), math.log(rescale)
    ji = jnp.exp(jax.random.uniform(kj, (2,), minval=-jm, maxval=jm))
    re = jnp.exp(jax.random.uniform(kr, (1,), minval=-rm, maxval=rm))
    return RopeDraws(shift=tuple(float(a) for a in sh), jitter=tuple(float(a) for a in ji),
                     rescale=float(re[0]))


@pytest.mark.parametrize("h,w", [(6, 10), (16, 16)])
def test_rope_train_augmentation_matches_flax(h, w):
    aug = dict(shift_coords=0.3, jitter_coords=1.5, rescale_coords=2.0)
    jr = JRoPE(embed_dim=64, num_heads=2, **aug)
    jp = jr.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 64)))
    key = jax.random.PRNGKey(5)
    want = jr.apply(jp, h, w, train=True, rng=key, method=jr.tables)
    rope = RoPE(64, 2, **aug)
    draws = _jax_draws(5, 0.3, 1.5, 2.0)
    for got, ref in zip(rope.tables(h, w, train=True, draws=draws), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    x = _rand(11, 1, h, w, 64)
    np.testing.assert_allclose(
        rope(torch.from_numpy(x), train=True, draws=draws).numpy(),
        np.asarray(jr.apply(jp, jnp.asarray(x), train=True, rng=key)), **TOL)
    # the port's own draws: within the bounds, reproducible from the generator
    d1 = rope.draw(torch.Generator().manual_seed(3))
    assert d1 == rope.draw(torch.Generator().manual_seed(3))
    assert all(abs(s) <= 0.3 for s in d1.shift)
    assert all(1 / 1.5 <= j <= 1.5 for j in d1.jitter) and 0.5 <= d1.rescale <= 2.0
    # not training, or training with neither draws nor a generator: no augmentation
    plain = rope.tables(h, w)
    for a, b in zip(rope.tables(h, w, draws=draws), plain):
        torch.testing.assert_close(a, b)
    for a, b in zip(rope.tables(h, w, train=True), plain):
        torch.testing.assert_close(a, b)
