"""The port's banded and streamed inference against naf_tpu, f32 on CPU.

RoPE's banded tables and pooled-key band sums, the banded two-pass encoder,
the banded variants of K2 and K3 (plain versions against the Pallas kernels
in interpret mode), ``NAF(band_rows)`` and ``naf_streamed``, on the same
seeded numpy inputs, at atol = rtol = 2e-4 (5e-4 for the streamed banded
encoder, whose band-by-band f32 statistics differ from the full-image sums
in order only, the JAX package's own bar). The ``cuda``-marked tests skip
here; ``chip_smoke.py`` holds the kernels on the card at production shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.api import naf_streamed
from naf_torch.convert import encoder_state_dict_from_jax, state_dict_from_jax_params
from naf_torch.kernels.encoder_banded import (
    encoder_stack_banded,
    encoder_stack_banded_rows,
    encoder_stack_stats,
)
from naf_torch.kernels.encoder_fused import _gn_affine, _stack_params
from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused, cross_scale_na2d_fused_ref
from naf_torch.kernels.na2d_fused_q import naf_upsample_attention, naf_upsample_attention_ref
from naf_torch.models.naf import NAF
from naf_torch.nn import Encoder, RoPE
from naf_tpu.api import naf_streamed as j_naf_streamed
from naf_tpu.kernels import encoder_banded as j_banded
from naf_tpu.kernels.na2d_fused import cross_scale_na2d_fused as j_fused_na
from naf_tpu.kernels.na2d_fused_q import naf_upsample_attention as j_fused_q
from naf_tpu.kernels.na2d_fused_q import pick_geometry
from naf_tpu.models.naf import NAF as JNAF
from naf_tpu.nn import RoPE as JRoPE
from naf_tpu.nn.conv import Encoder as JEncoder

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ropes(c=64, n=2):
    jr = JRoPE(embed_dim=c, num_heads=n)
    return jr, jr.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, c))), RoPE(c, n)


@pytest.mark.parametrize("row_offset,h,full_h", [(0, 8, 24), (8, 8, 24), (20, 4, 24)])
def test_rope_banded_tables_and_forward_match_jax(row_offset, h, full_h):
    jr, jp, rope = _ropes()
    want = jr.apply(jp, h, 12, row_offset=row_offset, full_h=full_h, method=jr.tables)
    got = rope.tables(h, 12, row_offset=row_offset, full_h=full_h)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    x = _rand(1, 1, h, 12, 64)
    want_x = jr.apply(jp, jnp.asarray(x), row_offset=row_offset, full_h=full_h)
    got_x = rope(torch.from_numpy(x), row_offset=row_offset, full_h=full_h)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    # the band is that slice of the full grid's RoPE
    xf = torch.from_numpy(_rand(3, 1, full_h, 12, 64))
    band = xf[:, row_offset : row_offset + h]
    np.testing.assert_allclose(rope(band, row_offset=row_offset, full_h=full_h).numpy(),
                               rope(xf)[:, row_offset : row_offset + h].numpy(), **TOL)


@pytest.mark.parametrize("hi,up", [(16, 48), (16, 16)])  # pool-up, and the identity size
def test_rope_pooled_band_contributions_match_jax_and_sum_to_the_keys(hi, up):
    jr, jp, rope = _ropes()
    x = _rand(2, 1, hi, 12, 64)
    total = 0
    for r0 in range(0, hi, 4):
        band = x[:, r0 : r0 + 4]
        want = jr.apply(jp, jnp.asarray(band), (up, up), (8, 8), row0=r0, full_h=hi,
                        method=jr.pooled)
        got = rope.pooled(torch.from_numpy(band), (up, up), (8, 8), row0=r0, full_h=hi)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        total = total + got
    np.testing.assert_allclose(total.numpy(), rope.pooled(torch.from_numpy(x), (up, up),
                                                          (8, 8)).numpy(), **TOL)


def _encoders(k, hidden=16, seed=0):
    """The JAX banded encoder test's setup: a k x k stack of 2 blocks, x (2, 32, 24, 3)."""
    jenc = JEncoder(hidden, kernel_size=k, ks_res=k, num_layers=2)
    x = _rand(seed, 2, 32, 24, 3)
    params = jenc.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    enc = Encoder(hidden, kernel_size=k, ks_res=k, num_layers=2)
    enc.load_state_dict(encoder_state_dict_from_jax(params, 2))
    return params, enc, x


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("band_rows", [8, 12, 32])
def test_banded_encoder_matches_jax(k, band_rows):
    params, enc, x = _encoders(k)
    want = j_banded.encoder_stack_banded(params, jnp.asarray(x), 16, k, k, band_rows=band_rows)
    with torch.no_grad():
        got = encoder_stack_banded(enc, torch.from_numpy(x), band_rows)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # the modules' own full-resolution forward
        np.testing.assert_allclose(got.numpy(), enc(torch.from_numpy(x)).numpy(), **TOL)


def test_banded_encoder_rows_stream_any_range():
    params, enc, x = _encoders(3)
    j_stats = j_banded.encoder_stack_stats(params, jnp.asarray(x), 3, 3, band_rows=8)
    with torch.no_grad():
        stats = encoder_stack_stats(enc, torch.from_numpy(x), band_rows=8)
        # the port passes each layer's channel sums; its chain folds them as
        # the JAX sweep does
        tp = _stack_params(enc)
        for ps, gamma, beta, (js, jt) in zip(stats, tp[2::4], tp[3::4], j_stats):
            s, t = _gn_affine(ps, gamma, beta, x.shape[1] * x.shape[2], enc.num_groups, enc.eps)
            np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)
        for r0, n in ((0, 8), (8, 16), (24, 8), (4, 12)):
            want = j_banded.encoder_stack_banded_rows(params, jnp.asarray(x), r0, n, j_stats, 3, 3)
            got = encoder_stack_banded_rows(enc, torch.from_numpy(x), r0, n, stats)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _fused_q_band_inputs():
    """tests/test_kernel_fused_q.py's banded setup: enc 32^2 x 128, 64^2
    output, 16^2 x 96 values, 2 heads."""
    hi, out, hk, n, c, cv = 32, 64, 16, 2, 128, 96
    rng = np.random.RandomState(2)
    enc = rng.randn(1, hi, hi, c).astype(np.float32)
    values = rng.randn(1, hk, hk, cv).astype(np.float32)
    jr = JRoPE(embed_dim=c, num_heads=n)
    jp = jr.init(jax.random.PRNGKey(0), jnp.asarray(enc))
    keys = np.array(jr.apply(jp, jnp.asarray(enc), up_hw=(out, out), down_hw=(hk, hk),
                               method=jr.pooled))
    sin_r, cos_r, sin_c, cos_c = jr.apply(jp, out, out, method=jr.tables)
    rows = np.concatenate([cos_r, sin_r], -1)
    cols = np.concatenate([cos_c, sin_c], -1)
    band = pick_geometry(out, out, hi, hi, hk, hk, 9, n, c // n, cv // n)[0] * 2
    return (enc, keys, values, rows, cols), band, c // n


@pytest.mark.parametrize("variant", ["slab", "out_acc", "enc_banded"])
def test_fused_q_banded_ref_matches_pallas(variant):
    """K2's banded plain version against the TPU kernel's banded calls in
    interpret mode: one cell-row band at a time, as a slab, written into a
    shared output in place, and from the band's encoder rows alone."""
    arrays, band, dh = _fused_q_band_inputs()
    kw = dict(num_heads=2, kernel_size=9)
    enc = arrays[0]
    want_acc = got_acc = None
    if variant != "slab":
        want_acc = jnp.full((1, 64, 64, 96), 7.0, jnp.float32)
        got_acc = torch.full((1, 64, 64, 96), 7.0)
    for c0 in range(0, 16, band):
        ins = list(arrays)
        banded = variant == "enc_banded"
        if banded:  # 4 output rows per cell row, 2 per input row
            ins[0] = enc[:, c0 * 2 : (c0 + band) * 2]
        args = dict(row_cell0=c0, band_cells=band)
        want = j_fused_q(*map(jnp.asarray, ins), dh, **kw, interpret=True, **args,
                         out_acc=want_acc, enc_banded=banded)
        got = naf_upsample_attention_ref(*map(torch.from_numpy, ins), dh, **kw, **args,
                                         out_acc=got_acc, enc_banded=banded)
        if variant == "slab":
            assert got.shape == (1, band * 4, 64, 96)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        else:
            want_acc = want
            assert got is got_acc
            if c0 == 0:  # rows of later bands are still as they were
                assert bool((got_acc[:, band * 4 :] == 7.0).all())
    if variant != "slab":
        np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_acc), **TOL)
        # and the bands together are the full-grid kernel's output
        full = naf_upsample_attention_ref(*map(torch.from_numpy, arrays), dh, **kw)
        np.testing.assert_allclose(got_acc.numpy(), full.numpy(), **TOL)


def test_fused_q_banded_validation_and_no_gradient():
    arrays, band, dh = _fused_q_band_inputs()
    args = [torch.from_numpy(a) for a in arrays]
    kw = dict(num_heads=2, kernel_size=9)
    with pytest.raises(ValueError, match="enc_banded requires band_cells"):
        naf_upsample_attention(*args, dh, **kw, enc_banded=True)
    with pytest.raises(ValueError, match="outside"):
        naf_upsample_attention(*args, dh, **kw, row_cell0=12, band_cells=8)
    with pytest.raises(ValueError, match="do not divide evenly"):
        naf_upsample_attention(args[0][:, :5], *args[1:], dh, **kw, row_cell0=0,
                               band_cells=3, enc_banded=True)
    with pytest.raises(ValueError, match="out_acc"):
        naf_upsample_attention(*args, dh, **kw, row_cell0=0, band_cells=4,
                               out_acc=torch.zeros(1, 64, 64, 95))
    # a slab is differentiable; out_acc writes in place and has no gradient
    enc = args[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        naf_upsample_attention(enc, *args[1:], dh, **kw, row_cell0=4, band_cells=4,
                               out_acc=torch.zeros(1, 64, 64, 96))


def test_fused_na_banded_ref_matches_pallas_and_k4_raises():
    """K3's banded plain version (q = the rows of cell rows [4, 8) of a
    48-row grid) against the TPU kernel's banded forward in interpret mode.
    The JAX package's banded kernel has no backward; the port's band does
    (K4's plain version on the band's rows): its dq is the band's rows of
    the whole grid's."""
    rng = np.random.RandomState(10)
    q = rng.randn(1, 16, 48, 2, 16).astype(np.float32)
    k = rng.randn(1, 12, 12, 2, 16).astype(np.float32)
    v = rng.randn(1, 12, 12, 2, 24).astype(np.float32)
    band = dict(row_cell0=4, full_hq=48)
    want = j_fused_na(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 5, interpret=True, **band)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = cross_scale_na2d_fused_ref(*args, 5, **band)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(cross_scale_na2d_fused(*args, 5, **band), got)
    with pytest.raises(ValueError, match="whole cell rows"):
        cross_scale_na2d_fused(args[0][:, :5], *args[1:], 5, **band)
    qg = args[0].clone().requires_grad_()
    cross_scale_na2d_fused(qg, *args[1:], 5, **band).sum().backward()
    whole = torch.from_numpy(rng.randn(1, 48, 48, 2, 16).astype(np.float32))
    whole[:, 16:32] = args[0]
    whole.requires_grad_()
    cross_scale_na2d_fused(whole, *args[1:], 5)[:, 16:32].sum().backward()
    torch.testing.assert_close(qg.grad, whole.grad[:, 16:32], atol=2e-3, rtol=2e-3)


def test_naf_band_rows_matches_jax_banded_model():
    """NAF(band_rows) against the JAX model's banded fused-q forward
    (na_impl="fused_q" runs its kernel in interpret mode off the TPU), and
    against the port's own unbanded forward."""
    kw = dict(dim=128, heads_attn=2, heads_rope=2, kernel_size=9, img_layers=1)
    img, feats = _rand(1, 1, 32, 32, 3), _rand(2, 1, 16, 16, 64)
    jm = JNAF(na_impl="fused_q", **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(feats), (64, 64))
    want = jm.apply(params, jnp.asarray(img), jnp.asarray(feats), (64, 64), band_rows=16)
    model = NAF(**kw)
    model.load_state_dict(state_dict_from_jax_params(params["params"], img_layers=1,
                                                     heads_rope=2))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(feats), (64, 64), band_rows=16)
        full = model(torch.from_numpy(img), torch.from_numpy(feats), (64, 64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


def _streamed_setup():
    """tests/test_streamed.py's setup: dim 128, 2 + 2 heads, k 5, one
    encoder block; 32^2 image, 16^2 x 96 features, 64^2 output."""
    kw = dict(dim=128, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=1)
    rng = np.random.RandomState(0)
    img = rng.randn(1, 32, 32, 3).astype(np.float32)
    feats = rng.randn(1, 16, 16, 96).astype(np.float32)
    jm = JNAF(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(feats),
                     (64, 64))["params"]
    model = NAF(**kw)
    model.load_state_dict(state_dict_from_jax_params(params, img_layers=1, heads_rope=2))
    return jm, params, model.eval(), img, feats


@pytest.mark.parametrize("stream_encoder,tol", [(False, 2e-4), (True, 5e-4)])
def test_naf_streamed_matches_jax(stream_encoder, tol):
    jm, params, model, img, feats = _streamed_setup()
    want = j_naf_streamed(jm, params, jnp.asarray(img), jnp.asarray(feats), (64, 64),
                          band_rows=16, interpret=True, stream_encoder=stream_encoder)
    got = naf_streamed(model, img, feats, (64, 64), band_rows=16, stream_encoder=stream_encoder)
    assert got.shape == (1, 64, 64, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def test_naf_streamed_validates_and_turns_the_encoder_on_by_size(monkeypatch):
    _, _, model, img, feats = _streamed_setup()
    with pytest.raises(ValueError, match="band_rows must divide"):
        naf_streamed(model, img, feats, (64, 64), band_rows=24)
    with pytest.raises(ValueError, match="whole encoder rows"):
        naf_streamed(model, img[:, :30, :30], feats, (64, 64), band_rows=4,
                     stream_encoder=True)
    import naf_torch.api as api

    seen = []
    monkeypatch.setattr(api, "_naf_streamed_banded_encoder",
                        lambda *a: seen.append(a[5:7]) or torch.zeros(()))
    naf_streamed(model, img, feats, (64, 64), band_rows=16)
    assert not seen  # 32^2 x 128 channels is far below 1.5 GiB
    big = np.zeros((1, 2048, 1600, 3), np.float32)  # 2048*1600*128*4 B = 1.56 GiB
    naf_streamed(model, big, feats, (512, 512), band_rows=32)
    assert seen == [(2048, 1600)]


def test_band_rows_in_training_is_ignored_and_return_weights_unbanded():
    _, _, model, img, feats = _streamed_setup()
    x, f = torch.from_numpy(img), torch.from_numpy(feats)
    with torch.no_grad():
        plain, w = model(x, f, (64, 64), return_weights=True)
        banded, wb = model(x, f, (64, 64), return_weights=True, band_rows=16)
    torch.testing.assert_close(banded, plain)
    torch.testing.assert_close(wb, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py holds the kernels on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("enc_banded", [False, True])
def test_banded_k2_kernel_matches_plain_on_card(cuda_device, enc_banded):
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays, band, dh = _fused_q_band_inputs()
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    kw = dict(num_heads=2, kernel_size=9, row_cell0=band, band_cells=band,
              enc_banded=enc_banded)
    if enc_banded:
        args[0] = args[0][:, band * 2 : band * 4].contiguous()
    got = torch.full((1, 64, 64, 96), 7.0, device=cuda_device)
    want = got.clone()
    launches = naf_upsample_attention.launches
    naf_upsample_attention(*args, dh, **kw, out_acc=got)
    assert naf_upsample_attention.launches == launches + 1
    naf_upsample_attention_ref(*args, dh, **kw, out_acc=want)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_banded_k3_kernel_matches_plain_on_card(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(10)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(cuda_device)
               for s in ((1, 16, 48, 2, 16), (1, 12, 12, 2, 16), (1, 12, 12, 2, 24)))
    launches = cross_scale_na2d_fused.launches
    got = cross_scale_na2d_fused(q, k, v, 5, row_cell0=4, full_hq=48)
    assert cross_scale_na2d_fused.launches == launches + 1
    torch.testing.assert_close(got, cross_scale_na2d_fused_ref(q, k, v, 5, row_cell0=4,
                                                               full_hq=48), **TOL)
