"""The host side of the tensor-core encoder kernels (K1 and K6 in bf16), on
the CPU: the packed B operand (``pack_weights_tc``), the pixel-tile and halo
plan (``tile_plan``), and a plain torch emulation of the kernels' order of
work (halo tile -> per-tap shifted windows -> products accumulated in f32
over the packed weight stages -> bias -> per-tile partial sums), held in f32
against the plain versions and the JAX Pallas kernels in interpret mode,
atol = rtol = 2e-4; and the wrappers' choice of kernel by dtype.

The CUDA kernels themselves run only on the card (``test_torch_kernels.py``'s
``cuda``-marked tests and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from naf_torch.kernels import _build
from naf_torch.kernels import encoder_fused as t_enc
from naf_torch.kernels.encoder_fused import (
    TILE,
    gn_silu_conv_dual_fused,
    gn_silu_conv_dual_ref,
    gn_silu_conv_fused,
    gn_silu_conv_ref,
    pack_weights_tc,
    tile_plan,
)
from naf_tpu.kernels import encoder_fused as j_enc

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _stream_order(c, k):
    """(tap, first channel) of each weight stage: 64-channel blocks, then
    taps row-major."""
    return [(tap, cb) for cb in range(0, c, 64) for tap in range(k * k)]


def _unswizzle(packed):
    """(blocks, steps, N, 64) stages -> (blocks, steps, 64, N) matrices B[kk, n],
    reading row n's 16-byte chunk j at position j ^ (n % 8)."""
    n_block = packed.shape[2]
    n = torch.arange(n_block)[None, :].expand(64, -1)
    kk = torch.arange(64)[:, None]
    phys = ((kk // 8) ^ (n % 8)) * 8 + kk % 8
    return packed[:, :, n, phys]


@pytest.mark.parametrize("f,c,k,n_block", [
    (128, 128, 3, 128), (128, 128, 1, 128), (64, 48, 1, 64), (128, 160, 3, 128), (192, 32, 3, 64),
])
def test_packed_weights_unpack_to_the_weight(f, c, k, n_block):
    w = torch.from_numpy(np.random.RandomState(0).randn(f, c, k, k).astype(np.float32))
    packed = pack_weights_tc([w], n_block)
    order = _stream_order(c, k)
    assert packed.shape == (-(-f // n_block), len(order), n_block, 64)
    b = _unswizzle(packed)
    got = torch.zeros(packed.shape[0] * n_block, -(-c // 64) * 64 + 64, k, k)
    for s, (tap, cb) in enumerate(order):
        got[:, cb : cb + 64, tap // k, tap % k] = b[:, s].permute(0, 2, 1).reshape(-1, 64)
    torch.testing.assert_close(got[:f, :c], w, atol=0, rtol=0)
    assert not got[f:].any() and not got[:, c:].any()  # zero past F and C
    # the wrappers' cached gather gives the same stream, two weights back to back
    w2 = torch.from_numpy(np.random.RandomState(1).randn(f, c, 3, 3).astype(np.float32))
    torch.testing.assert_close(t_enc._packed((w, w2), n_block, torch.float32),
                               pack_weights_tc([w, w2], n_block).flatten(), atol=0, rtol=0)


@pytest.mark.parametrize("h,w,k", [(16, 16, 3), (13, 21, 3), (13, 21, 1), (2, 5, 3), (262, 452, 3)])
def test_tile_plan_reflects_like_torch(h, w, k):
    tiles_h, tiles_w, rows, cols = tile_plan(h, w, k)
    assert (tiles_h, tiles_w) == (-(-h // TILE[0]), -(-w // TILE[1]))
    p = k // 2
    for n, t, src in ((h, TILE[0], rows), (w, TILE[1], cols)):
        assert src.shape == (-(-n // t), t + 2 * p)
        padded = F.pad(torch.arange(n, dtype=torch.float32)[None, None], (p, p),
                       mode="reflect")[0, 0].long() if p else torch.arange(n)
        want = torch.arange(src.shape[0])[:, None] * t + torch.arange(t + 2 * p)[None, :]
        inside = want < n + 2 * p  # past a ragged edge: clamped, never stored
        assert torch.equal(src[inside], padded[want[inside]])
        assert bool(((src >= 0) & (src < n)).all())


def _emulate(z, packed, bias, k):
    """The tensor-core kernels' order of work on an activated input z
    (B, H, W, C) f32, for one stream of stages (``pack_weights_tc``): per
    8 x 16 tile its halo rows and columns (``tile_plan``); per block of
    N output channels, the stages in stream order (64-channel blocks, then
    taps), each a (128 x <=64) by (<=64 x N) product accumulated in f32;
    bias; y and the tile's [sum, sumsq] over its valid pixels. Returns (y (B, H, W, F), partials (B,
    tiles, 2, F)) with F = len(bias)."""
    b, h, w, c = z.shape
    th, tw = TILE
    tiles_h, tiles_w, rows, cols = tile_plan(h, w, k)
    mats = _unswizzle(packed)
    nb, steps, _, n_block = mats.shape
    f = bias.shape[0]
    bias_p = torch.zeros(nb * n_block)
    bias_p[:f] = bias
    y = torch.zeros(b, tiles_h * th, tiles_w * tw, nb * n_block)
    part = torch.zeros(b, tiles_h * tiles_w, 2, nb * n_block)
    for bi in range(b):
        for ty in range(tiles_h):
            for tx in range(tiles_w):
                halo = z[bi][rows[ty]][:, cols[tx]]
                acc = torch.zeros(th * tw, nb * n_block)
                for fb in range(nb):
                    s = 0
                    for cb in range(0, c, 64):
                        for tap in range(k * k):
                            dy, dx = divmod(tap, k)
                            a = halo[dy : dy + th, dx : dx + tw, cb : cb + 64].reshape(th * tw, -1)
                            acc[:, fb * n_block : (fb + 1) * n_block] += a @ mats[fb, s, : a.shape[1]]
                            s += 1
                    assert s == steps
                yt = acc + bias_p
                valid = ((ty * th + torch.arange(th)[:, None] < h)
                         & (tx * tw + torch.arange(tw)[None, :] < w)).reshape(-1)
                part[bi, ty * tiles_w + tx, 0] = yt[valid].sum(0)
                part[bi, ty * tiles_w + tx, 1] = (yt[valid] ** 2).sum(0)
                y[bi, ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw] = yt.reshape(th, tw, -1)
    return y[:, :h, :w, :f], part[..., :f]


def _inputs(seed, b, h, w, c):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    sc = (rng.rand(b, c) + 0.5).astype(np.float32)
    sh = (rng.randn(b, c) * 0.1).astype(np.float32)
    return x, sc, sh


def _activated(x, sc, sh):
    return F.silu(torch.from_numpy(x) * torch.from_numpy(sc)[:, None, None]
                  + torch.from_numpy(sh)[:, None, None])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("b,h,w,c,f", [
    (1, 16, 16, 128, 128),  # whole tiles
    (2, 13, 24, 128, 128),  # ragged in both axes of the 8 x 16 tile; the Pallas kernel takes it
    (1, 13, 21, 160, 64),   # ragged; two halo loads, a 32-channel block; F = 64 blocks
])
def test_emulated_k1_matches_plain_and_pallas(k, b, h, w, c, f):
    x, sc, sh = _inputs(0, b, h, w, c)
    rng = np.random.RandomState(1)
    wt = (rng.randn(f, c, k, k) * (c * k * k) ** -0.5).astype(np.float32)
    bias = (rng.randn(f) * 0.1).astype(np.float32)
    n_block = 128 if f % 128 == 0 else 64
    y, part = _emulate(_activated(x, sc, sh), pack_weights_tc([torch.from_numpy(wt)], n_block),
                       torch.from_numpy(bias), k)
    ps = part.sum(dim=1)
    want_y, want_ps = gn_silu_conv_ref(*map(torch.from_numpy, (x, sc, sh, wt, bias)))
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(ps / (h * w), want_ps / (h * w), **TOL)
    if w % 8 == 0:  # the Pallas kernel's own shape rule
        jy, jps = j_enc.gn_silu_conv_fused(
            jnp.asarray(x), jnp.asarray(sc), jnp.asarray(sh),
            jnp.asarray(wt.transpose(2, 3, 1, 0)), jnp.asarray(bias), kernel_size=k,
            interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(ps.numpy() / (h * w), np.asarray(jps) / (h * w), **TOL)


@pytest.mark.parametrize("b,h,w,c", [(1, 16, 16, 128), (2, 13, 21, 48)])
def test_emulated_k6_matches_plain_and_pallas(b, h, w, c):
    """K6's stream: the pixel half's 1x1 stages, then the semantic half's
    3x3 stages, each half's tiles into its half of the packed output."""
    x, sc, sh = _inputs(2, b, h, w, 2 * c)
    rng = np.random.RandomState(3)
    wp = (rng.randn(c, c, 1, 1) * c ** -0.5).astype(np.float32)
    ws = (rng.randn(c, c, 3, 3) * (9 * c) ** -0.5).astype(np.float32)
    bp, bs = ((rng.randn(c) * 0.1).astype(np.float32) for _ in range(2))
    n_block = 128 if c > 64 else 64
    packed = pack_weights_tc([torch.from_numpy(wp), torch.from_numpy(ws)], n_block)
    steps_p = len(_stream_order(c, 1))
    z = _activated(x, sc, sh)
    yp, pp = _emulate(z[..., :c], packed[:, :steps_p], torch.from_numpy(bp), 1)
    ys, ps_ = _emulate(z[..., c:], packed[:, steps_p:], torch.from_numpy(bs), 3)
    y, ps = torch.cat([yp, ys], dim=-1), torch.cat([pp, ps_], dim=-1).sum(dim=1)
    args = (x, sc, sh, wp, ws, bp, bs)
    want_y, want_ps = gn_silu_conv_dual_ref(*map(torch.from_numpy, args))
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(ps / (h * w), want_ps / (h * w), **TOL)
    if c % 128 == 0:  # the Pallas kernel's lane rule
        jargs = (x, sc, sh, wp.transpose(2, 3, 1, 0), ws.transpose(2, 3, 1, 0), bp, bs)
        jy, jps = j_enc.gn_silu_conv_dual_fused(*map(jnp.asarray, jargs), interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(ps.numpy() / (h * w), np.asarray(jps) / (h * w), **TOL)


def test_kernel_is_chosen_by_dtype_alone():
    """On CUDA, bf16 launches the tensor-core kernel and f32 the CUDA-core
    kernel, decided from the dtype before any launch; each library has both
    entry points, and the tensor-core core holds wgmma."""
    for dt, route in ((torch.bfloat16, "wgmma"), (torch.float32, "fma")):
        assert t_enc._route(torch.zeros(1, 8, 16, 64, dtype=dt, device="meta").dtype) == route
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_enc._route(torch.float16)
    for lib, entry in (("encoder_fused", "naf_gn_silu_conv"),
                       ("encoder_dual", "naf_gn_silu_conv_dual")):
        src = (_build.CSRC / f"{lib}.cu").read_text()
        assert f"int {entry}_wgmma(" in src and f"int {entry}_fma(" in src
        assert '#include "encoder_tc.cuh"' in src
    assert "wgmma.mma_async" in (_build.CSRC / "encoder_tc.cuh").read_text()
    # a tensor on neither CPU nor CUDA is refused in either dtype
    for dt in (torch.bfloat16, torch.float32):
        meta = dict(device="meta", dtype=dt)
        with pytest.raises(ValueError, match="CUDA"):
            gn_silu_conv_fused(torch.zeros(1, 8, 16, 64, **meta), torch.ones(64, device="meta"),
                               torch.zeros(64, device="meta"),
                               torch.zeros(64, 64, 3, 3, **meta), torch.zeros(64, device="meta"))
        with pytest.raises(ValueError, match="CUDA"):
            gn_silu_conv_dual_fused(torch.zeros(1, 8, 16, 64, **meta),
                                    torch.ones(64, device="meta"), torch.zeros(64, device="meta"),
                                    torch.zeros(32, 32, 1, 1, **meta),
                                    torch.zeros(32, 32, 3, 3, **meta),
                                    torch.zeros(32, device="meta"), torch.zeros(32, device="meta"))


def test_ablations_apply_to_the_core():
    """naf_torch.tools.ablate_encoder_tc edits the sources as they stand."""
    from naf_torch.tools import ablate_encoder_tc as abl

    core = (_build.CSRC / "encoder_tc.cuh").read_text()
    for core_edits, c_edits in abl.VARIANTS.values():
        abl._edit(core, core_edits, "encoder_tc.cuh")
        for lib in ("encoder_fused", "encoder_dual"):
            abl._edit((_build.CSRC / f"{lib}.cu").read_text(), c_edits, lib)
