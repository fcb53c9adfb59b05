"""The port's kernels' plain versions against the JAX Pallas kernels (run in
interpret mode, as the JAX package's own tests run them), f32 on CPU,
atol = rtol = 2e-4; and the wrappers' dispatch rules.

The CUDA kernels themselves run only on the card: the ``cuda``-marked tests
skip here (K1's and K6's are in ``test_torch_card_encoder.py``, K2's in
``test_torch_card_fused_q.py``, which import no JAX, so that they also run
where the JAX package is not installed), and
``chip_smoke.py`` holds each kernel against its plain version at the
production shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.convert import encoder_state_dict_from_jax
from naf_torch.kernels import _build
from naf_torch.kernels import encoder_fused as t_enc
from naf_torch.kernels.encoder_fused import (
    encoder_stack_fused,
    encoder_stack_fused_packed,
    gn_silu_conv_dual_fused,
    gn_silu_conv_dual_ref,
    gn_silu_conv_fused,
    gn_silu_conv_ref,
)
from naf_torch.kernels.na2d_fused import (
    _box,
    _plan,
    cross_scale_na2d_fused,
    cross_scale_na2d_fused_bwd_ref,
    cross_scale_na2d_fused_ref,
)
from naf_torch.kernels.na2d_fused_q import (
    fused_q_twin,
    naf_upsample_attention,
    naf_upsample_attention_ref,
)
from naf_torch.nn import Encoder
from naf_torch.ops.window import cross_scale_lr_indices
from naf_tpu.kernels import encoder_fused as j_enc
from naf_tpu.kernels.na2d_fused import cross_scale_na2d_fused as j_fused_na
from naf_tpu.kernels.na2d_fused_q import naf_upsample_attention as j_fused_q
from naf_tpu.nn import Encoder as JEncoder
from naf_tpu.nn import RoPE as JRoPE

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _rand(seed, *shape, s=1.0):
    return (np.random.RandomState(seed).randn(*shape) * s).astype(np.float32)


def _layer_inputs(k, b=1, c=128, f=128, hw=16):
    return (_rand(0, b, hw, hw, c), (np.random.RandomState(1).rand(b, c) + 0.5).astype(np.float32),
            _rand(2, b, c, s=0.1), _rand(3, k, k, c, f, s=0.05), _rand(4, f, s=0.1))


@pytest.mark.parametrize("k,b", [(1, 1), (3, 1), (3, 2)])
def test_gn_silu_conv_ref_matches_pallas(k, b):
    x, sc, sh, w, bias = _layer_inputs(k, b)
    want_y, want_ps = j_enc.gn_silu_conv_fused(
        jnp.asarray(x), jnp.asarray(sc), jnp.asarray(sh), jnp.asarray(w), jnp.asarray(bias),
        kernel_size=k, interpret=True)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got_y, got_ps = gn_silu_conv_ref(torch.from_numpy(x), torch.from_numpy(sc),
                                     torch.from_numpy(sh), wt, torch.from_numpy(bias))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    # psums are sums over H*W pixels; GroupNorm reads them as means
    np.testing.assert_allclose(got_ps.numpy() / 256, np.asarray(want_ps) / 256, **TOL)
    # on CPU tensors the wrapper is the plain version
    y, ps = gn_silu_conv_fused(torch.from_numpy(x), torch.from_numpy(sc),
                               torch.from_numpy(sh), wt, torch.from_numpy(bias))
    torch.testing.assert_close(y, got_y)
    torch.testing.assert_close(ps, got_ps)


def _jax_stacks(x, hidden=128):
    trees, mods = [], []
    rng = np.random.RandomState(5)
    for ks in (1, 3):
        jenc = JEncoder(hidden, kernel_size=ks, ks_res=ks, num_layers=2)
        p = jenc.init(jax.random.PRNGKey(ks), jnp.asarray(x))["params"]
        p = jax.tree.map(lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32), p)
        enc = Encoder(hidden, kernel_size=ks, ks_res=ks, num_layers=2)
        enc.load_state_dict(encoder_state_dict_from_jax(p, 2))
        trees.append(p)
        mods.append(enc)
    return trees, mods


def test_packed_stack_matches_pallas_packed_stack():
    x = _rand(6, 1, 16, 16, 3)
    (tp, ts), (mp, ms) = _jax_stacks(x)
    want = j_enc.encoder_stack_fused_packed(tp, ts, jnp.asarray(x), 128, 2, interpret=True)
    with torch.no_grad():
        got = encoder_stack_fused_packed(mp, ms, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # the fused-layer math (GroupNorm from channel sums) is the modules' math
        np.testing.assert_allclose(
            encoder_stack_fused(ms, torch.from_numpy(x)).numpy(),
            ms(torch.from_numpy(x)).numpy(), **TOL)


def _dual_inputs(b=1, c=128, hw=16):
    """A packed (b, hw, hw, 2c) layer input, f32 affines, and both stacks'
    weights in the JAX layout (HWIO)."""
    rng = np.random.RandomState(20)
    return (rng.randn(b, hw, hw, 2 * c).astype(np.float32),
            (rng.rand(b, 2 * c) + 0.5).astype(np.float32),
            (rng.randn(b, 2 * c) * 0.1).astype(np.float32),
            (rng.randn(1, 1, c, c) * 0.09).astype(np.float32),
            (rng.randn(3, 3, c, c) * 0.03).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32), (rng.randn(c) * 0.1).astype(np.float32))


def _dual_torch(x, sc, sh, wp, ws, bp, bs):
    """The same inputs as torch tensors, weights as (out, in, kh, kw)."""
    t = torch.from_numpy
    return (t(x), t(sc), t(sh), t(wp).permute(3, 2, 0, 1), t(ws).permute(3, 2, 0, 1), t(bp),
            t(bs))


def test_dual_layer_ref_matches_pallas():
    """K6's plain version against the TPU dual kernel in interpret mode."""
    args = _dual_inputs()
    want_y, want_ps = j_enc.gn_silu_conv_dual_fused(*map(jnp.asarray, args), interpret=True)
    got_y, got_ps = gn_silu_conv_dual_ref(*_dual_torch(*args))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_ps.numpy() / 256, np.asarray(want_ps) / 256, **TOL)
    # on CPU tensors the wrapper is the plain version
    y, ps = gn_silu_conv_dual_fused(*_dual_torch(*args))
    torch.testing.assert_close(y, got_y)
    torch.testing.assert_close(ps, got_ps)


def test_packed_stacks_match_pallas_dual_forward():
    """The per-stack packed encoder (K1's plain version here) against the
    JAX package's dual forward (both stacks as one packed stack, its dual
    kernel in interpret mode) at the JAX package's own bar for the two
    routes (atol 1e-5, rtol 1e-4)."""
    x = np.random.RandomState(4).randn(1, 32, 32, 3).astype(np.float32)
    (tp, ts), (mp, ms) = _jax_stacks(x)
    want = j_enc._dual_fwd_impl(tp, ts, jnp.asarray(x), 128, 2, 8, 1e-5, True)
    with torch.no_grad():
        got = encoder_stack_fused_packed(mp, ms, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_k6_shape_rule_and_refusals():
    """K6's own shape rule names what it refuses (C % 16, the weights'
    shapes), its source is built with the others, and its wrapper raises on
    tensors that are neither CPU nor CUDA."""
    assert "C % 16" in t_enc._dual_shape_error((1, 8, 8, 48), (24, 24, 1, 1), (24, 24, 3, 3))
    assert t_enc._dual_shape_error((1, 8, 8, 64), (32, 32, 1, 1), (32, 32, 3, 3)) is None
    assert "must be" in t_enc._dual_shape_error((1, 8, 8, 64), (32, 32, 3, 3), (32, 32, 1, 1))
    assert "reflect" in t_enc._dual_shape_error((1, 1, 8, 64), (32, 32, 1, 1), (32, 32, 3, 3))
    assert "encoder_dual" in _build.SOURCES
    meta = torch.zeros(1, 8, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gn_silu_conv_dual_fused(meta, torch.ones(64, device="meta"), torch.zeros(64, device="meta"),
                                torch.zeros(32, 32, 1, 1, device="meta"),
                                torch.zeros(32, 32, 3, 3, device="meta"),
                                torch.zeros(32, device="meta"), torch.zeros(32, device="meta"))


def _fused_q_inputs(hi, out, hk=16, c=128, cv=96, n=2):
    jr = JRoPE(embed_dim=c, num_heads=n)
    jp = jr.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, c)))
    enc = _rand(7, 1, hi, hi, c)
    values = _rand(8, 1, hk, hk, cv)
    keys = np.array(jr.apply(jp, jnp.asarray(enc), up_hw=(out, out), down_hw=(hk, hk),
                             method=jr.pooled))
    sin_r, cos_r, sin_c, cos_c = jr.apply(jp, out, out, method=jr.tables)
    rows = np.concatenate([cos_r, sin_r], -1)
    cols = np.concatenate([cos_c, sin_c], -1)
    return enc, keys, values, rows, cols, c // n


@pytest.mark.parametrize("hi,out", [(64, 64), (32, 64)])  # identity pool, pool-up
def test_fused_q_ref_matches_pallas(hi, out):
    enc, keys, values, rows, cols, dh = _fused_q_inputs(hi, out)
    want = j_fused_q(jnp.asarray(enc), jnp.asarray(keys), jnp.asarray(values),
                     jnp.asarray(rows), jnp.asarray(cols), dh, num_heads=2, kernel_size=9,
                     interpret=True)
    args = [torch.from_numpy(a) for a in (enc, keys, values, rows, cols)]
    got = naf_upsample_attention_ref(*args, dh, num_heads=2, kernel_size=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(
        naf_upsample_attention(*args, dh, num_heads=2, kernel_size=9), got)


@pytest.mark.parametrize("hq,hk,k,tile", [
    (448, 28, 9, 8), (2048, 28, 9, 8), (100, 28, 9, 4), (16, 8, 9, 2), (64, 16, 9, 8),
])
def test_kv_box_holds_every_window_cell(hq, hk, k, tile):
    idx = cross_scale_lr_indices(hq, hk, k)
    lo, ext = _box(idx, tile, hk)
    assert ext <= hk and (lo >= 0).all() and (lo + ext <= hk).all()
    for t, l0 in enumerate(lo):
        cells = idx[t * tile : (t + 1) * tile]
        assert (cells >= l0).all() and (cells < l0 + ext).all()


class _FakeLib:
    """Stands in for a kernel library: shared memory = 4 B per box cell."""

    @staticmethod
    def smem(d, dv, ks, rows, cols):
        return 4 * rows * cols


def test_plan_takes_the_first_tile_whose_box_fits():
    """The shared planner of K2-K4, on the CPU with a stand-in library: it
    tries the limits in order and the tiles largest first, and raises where
    nothing fits."""
    lib = functools.cache(lambda: _FakeLib)
    tiles = ((8, 8), (4, 4), (1, 1))
    args = (64, 64, 16, 16, 9, 16, 16, "cpu")
    box8 = _box(cross_scale_lr_indices(64, 16, 9), 8, 16)[1]
    box4 = _box(cross_scale_lr_indices(64, 16, 9), 4, 16)[1]
    assert box8 > box4
    tqh, tqw, urh, urw, idx_h, _, row_lo, _ = _plan(lib, "smem", tiles, (4 * box8 ** 2,), *args)
    assert (tqh, tqw, urh, urw) == (8, 8, box8, box8)
    np.testing.assert_array_equal(idx_h.numpy(), cross_scale_lr_indices(64, 16, 9))
    assert row_lo.shape == (8,)
    got = _plan(lib, "smem", tiles, (4 * box4 ** 2, 4 * box8 ** 2), *args)[:4]
    assert got == (4, 4, box4, box4)
    with pytest.raises(ValueError, match="no query tile fits shared memory by smem"):
        _plan(lib, "smem", tiles, (3,), *args)


def _qkv(hq, hk, n=2, d=16, dv=24, seed=10, b=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, h, n, c).astype(np.float32)
                 for h, c in ((hq, d), (hk, d), (hk, dv)))


@pytest.mark.parametrize("hq,hk,k", [(48, 12, 5), (26, 13, 9)])
def test_fused_na_ref_matches_pallas(hq, hk, k):
    q, kk, v = _qkv(hq, hk)
    want = j_fused_na(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v), k, interpret=True)
    args = [torch.from_numpy(a) for a in (q, kk, v)]
    got = cross_scale_na2d_fused_ref(*args, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # on CPU tensors the wrapper is the plain version
    torch.testing.assert_close(cross_scale_na2d_fused(*args, k), got)


def test_fused_na_backward_matches_pallas_backward():
    """The plain K4 and autograd of the wrapper on CPU tensors against
    jax.grad of the interpret-mode kernel, which runs the TPU backward
    kernel interpreted (2e-3)."""
    q, kk, v = _qkv(24, 12, b=2)
    dout = np.random.RandomState(11).randn(2, 24, 24, 2, 24).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: j_fused_na(*a, 5, interpret=True),
                     jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, kk, v)]
    got = cross_scale_na2d_fused_bwd_ref(*(a.detach() for a in args), torch.from_numpy(dout), 5)
    auto = torch.autograd.grad(cross_scale_na2d_fused(*args, 5), args, torch.from_numpy(dout))
    for g, a, w in zip(got, auto, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3)


def test_fused_q_twin_gradients_match_jax():
    """K2's backward (the twin: pool-up, RoPE, then K3/K4's plain versions)
    against jax.grad of naf_upsample_attention (2e-3)."""
    enc, keys, values, rows, cols, dh = _fused_q_inputs(32, 64)
    cot = np.random.RandomState(12).randn(1, 64, 64, 96).astype(np.float32)
    _, vjp = jax.vjp(
        lambda e, k, v: j_fused_q(e, k, v, jnp.asarray(rows), jnp.asarray(cols), dh,
                                  num_heads=2, kernel_size=9, interpret=True),
        jnp.asarray(enc), jnp.asarray(keys), jnp.asarray(values))
    want = vjp(jnp.asarray(cot))
    args = [torch.from_numpy(a).requires_grad_() for a in (enc, keys, values)]
    out = fused_q_twin(*args, torch.from_numpy(rows), torch.from_numpy(cols), dh,
                       num_heads=2, kernel_size=9)
    got = torch.autograd.grad(out, args, torch.from_numpy(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither CPU nor CUDA gets no quiet fallback."""
    x = torch.zeros(1, 8, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gn_silu_conv_fused(x, torch.ones(1, 16, device="meta"), torch.zeros(1, 16, device="meta"),
                           torch.zeros(64, 16, 3, 3, device="meta"),
                           torch.zeros(64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        naf_upsample_attention(x, x, x, torch.zeros(8, 32, device="meta"),
                               torch.zeros(8, 32, device="meta"), 8, num_heads=2,
                               kernel_size=3)
    q = torch.zeros(1, 8, 8, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cross_scale_na2d_fused(q, q[:, :4, :4], q[:, :4, :4], 3)


def test_build_paths_are_keyed_on_the_sources():
    names = {p.name for p in _build.CSRC.iterdir()}
    assert {f"{n}.cu" for n in _build.SOURCES} <= names
    assert {"encoder_fused", "na2d_fused_q", "na2d_fused"} <= set(_build.SOURCES)
    t = _build._target("encoder_fused")
    assert t.parent == _build.BUILD_DIR and t.name.startswith("libencoder_fused_")
    assert t == _build._target("encoder_fused")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py holds the kernels on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hk,k", [(48, 12, 5), (26, 13, 9), (16, 8, 9)])
def test_k3_k4_kernels_match_plain_on_card(cuda_device, hq, hk, k):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kk, v = (torch.from_numpy(a).to(cuda_device).requires_grad_() for a in _qkv(hq, hk))
    dout = torch.randn(1, hq, hq, 2, 24, device=cuda_device)
    launches = cross_scale_na2d_fused.launches, cross_scale_na2d_fused.bwd_launches
    out = cross_scale_na2d_fused(q, kk, v, k)
    got = torch.autograd.grad(out, (q, kk, v), dout)
    assert (cross_scale_na2d_fused.launches, cross_scale_na2d_fused.bwd_launches) == (
        launches[0] + 1, launches[1] + 1)
    torch.testing.assert_close(out, cross_scale_na2d_fused_ref(q, kk, v, k), **TOL)
    want = cross_scale_na2d_fused_bwd_ref(q.detach(), kk.detach(), v.detach(), dout, k)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_k6_is_inference_only_on_card(cuda_device):
    """K6 takes no gradient: the dual route differentiates the per-stack twin."""
    args = [t.to(cuda_device) for t in _dual_torch(*_dual_inputs(1))]
    args[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        gn_silu_conv_dual_fused(*args)
