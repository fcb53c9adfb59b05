"""The host side of K5 (FeatUp's spatially varying conv, ``csrc/adaptive_conv.cu``)
on the CPU: the plan of its two routes (``_plan_k5``) and a plain torch
emulation of each route's order of work:

    narrow (C <= 8): per block one row segment of up to 64 or 128 output
    pixels; its weights as the one contiguous range of ``kernel`` they are;
    the K x (segment + K - 1) source halo with the channels zero-padded to 4
    or 8 and zeros past the edge; per pixel the K^2 taps in row-major order,
    f32 accumulation;
    wide (C > 8): per block a TH x 16 tile and a chunk of 32-channel stages
    (the last stage's channels past C zero); the tile's weights tap-major,
    [K^2][TH*16 + 4], zero past the edge; per stage the (TH+K-1) x (16+K-1)
    halo; per pixel the tap rows in order, each row's taps in order (the
    halo streamed along the row), f32 accumulation, the stage's channels
    below C stored.

Each emulation is held against the plain version ``adaptive_conv_fused_ref``
and, on the same numpy inputs, JAX's ``naf_tpu.ops.adaptive_conv`` and, where
its shape rules take the shape (C % 128 == 0, k <= 11), the Pallas kernel in
interpret mode, at atol = rtol = 2e-4. The CUDA kernels themselves run on
the card (``test_torch_card_adaptive.py``, ``chip_smoke.py``).
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.kernels import _build
from naf_torch.kernels import adaptive_conv_fused as t_ac
from naf_torch.kernels.adaptive_conv_fused import _plan_k5, adaptive_conv_fused_ref
from naf_tpu.kernels.adaptive_conv_fused import (
    adaptive_conv_fused as j_adaptive_conv_fused,
)
from naf_tpu.kernels.adaptive_conv_fused import adaptive_conv_fused_applicable
from naf_tpu.ops import adaptive_conv as j_ac

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
KS = tuple(range(1, 16, 2))
CS = (1, 3, 4, 8, 9, 100, 384)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("k", KS)
def test_plan_routes_fit_and_cover(k, c, dtype):
    b, h, w = 2, 45, 70
    plan = _plan_k5(b, h, w, c, k, dtype)
    assert plan.route == ("narrow" if c <= t_ac.NARROW_MAX_C else "wide")
    assert plan.smem <= 227 * 1024 == t_ac.SMEM_LIMIT
    th, tw = plan.tile
    threads = th * tw  # a thread per pixel of the tile
    assert threads % 32 == 0 and threads <= 128
    assert t_ac._blocks_per_sm(threads, plan.smem) >= 1
    gx, gy, gz = plan.grid
    assert gz == b
    tiles_w = math.ceil(w / tw)
    assert gx == math.ceil(h / th) * tiles_w  # the tiles cover the output once
    itemsize = torch.empty((), dtype=dtype).element_size()
    if plan.route == "narrow":
        assert (th, gy, plan.stages) == (1, 1, 1)
        assert tw in t_ac.NARROW_TILES
        assert plan.smem == t_ac.narrow_smem(k, tw, c)
    else:
        nst = math.ceil(c / t_ac.WIDE_STAGE)
        # the chunks cover the stages once, none empty
        assert gy == math.ceil(nst / plan.stages) and (gy - 1) * plan.stages < nst
        assert tw == t_ac.WIDE_TW and th in t_ac.WIDE_TH
        assert plan.smem == t_ac.wide_smem(k, th, itemsize)


def test_plan_picks_every_candidate_tile():
    """Each tile the plan tries wins at some odd k <= 15, C and dtype: no
    candidate (and no launch the kernel source accepts) is dead."""
    picked = {(p.route, p.tile) for k in KS for c in CS + (5, 6) for dtype in DTYPES
              for p in [_plan_k5(1, 64, 64, c, k, dtype)]}
    assert picked == ({("narrow", (1, tw)) for tw in t_ac.NARROW_TILES}
                      | {("wide", (th, t_ac.WIDE_TW)) for th in t_ac.WIDE_TH})


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_plan_wide_grid_fills_the_card_at_featups_first_stage(dtype):
    plan = _plan_k5(1, 56, 56, 384, 7, dtype)
    assert plan.route == "wide"
    assert math.prod(plan.grid) >= t_ac.SMS
    # FeatUp's last stage needs no chunks: one block walks all 12 stages
    last = _plan_k5(1, 448, 448, 384, 7, dtype)
    assert last.grid[1] == 1 and last.stages == 12


def test_plan_keeps_eight_warps_per_sm_at_featups_width():
    plan = _plan_k5(1, 448, 448, 384, 7, torch.float32)
    threads = math.prod(plan.tile)
    assert t_ac._blocks_per_sm(threads, plan.smem) * threads // 32 >= 8


@pytest.mark.parametrize("c,k", [(384, 41), (9, 41), (3, 45), (8, 45)])
def test_plan_raises_where_no_tile_fits(c, k):
    """Windows past the kernels' k 15 whose weights or halo exceed a
    block's shared memory at every tile."""
    with pytest.raises(ValueError, match="no tile"):
        _plan_k5(1, 64, 64, c, k, torch.float32)


def test_plan_constants_match_the_kernel_source():
    """The plan sizes what csrc/adaptive_conv.cu refuses to launch otherwise:
    the constants of both must agree."""
    src = (_build.CSRC / "adaptive_conv.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src).group(1))

    assert const("MAX_K") == t_ac.MAX_K
    assert const("SMEM_LIMIT") == t_ac.SMEM_LIMIT
    assert const("WTW") == t_ac.WIDE_TW
    assert const("WCS") == t_ac.WIDE_STAGE
    assert const("WDEPTH") == t_ac.WIDE_DEPTH
    assert "TWN != 128 && TWN != 64 && TWN != 32" in src and t_ac.NARROW_TILES == (128, 64, 32)
    assert "TH != 8 && TH != 4)" in src and t_ac.WIDE_TH == (8, 4)


def _emulate_narrow(src, ker, plan):
    """The narrow route's order of work in torch, f32."""
    b, hp, wp, c = src.shape
    k = ker.shape[-1]
    h, w = hp - k + 1, wp - k + 1
    tw = plan.tile[1]
    cp = 4 * math.ceil(c / 4)
    flat = ker.float().reshape(-1)
    out = torch.zeros(b, h, w, c)
    for bb in range(b):
        for blk in range(plan.grid[0]):
            y, x0 = blk // math.ceil(w / tw), (blk % math.ceil(w / tw)) * tw
            n = min(tw, w - x0)
            lo = ((bb * h + y) * w + x0) * k * k
            wts = flat[lo : lo + n * k * k].reshape(n, k * k)  # one contiguous range
            halo = torch.zeros(k, tw + k - 1, cp)
            part = src[bb, y : y + k, x0 : x0 + tw + k - 1].float()
            halo[:, : part.shape[1], :c] = part
            acc = torch.zeros(n, cp)
            for i in range(k):
                for j in range(k):
                    acc += wts[:, i * k + j, None] * halo[i, j : j + n]
            out[bb, y, x0 : x0 + n] = acc[:, :c]
    return out


def _emulate_wide(src, ker, plan):
    """The wide route's order of work in torch, f32."""
    b, hp, wp, c = src.shape
    k = ker.shape[-1]
    h, w = hp - k + 1, wp - k + 1
    th, tw = plan.tile
    tile, tiles_w = th * tw, math.ceil(w / tw)
    stage = t_ac.WIDE_STAGE
    nst = math.ceil(c / stage)
    out = torch.zeros(b, h, w, c)
    for bb in range(b):
        for blk in range(plan.grid[0]):
            oy, ox = (blk // tiles_w) * th, (blk % tiles_w) * tw
            # tap-major weights with 4 floats of padding per tap row, zero
            # past the edge
            ws = torch.zeros(k * k, tile + 4)
            part = ker[bb, oy : oy + th, ox : ox + tw].float()
            wt = torch.zeros(th, tw, k * k)
            wt[: part.shape[0], : part.shape[1]] = part.reshape(*part.shape[:2], k * k)
            ws[:, :tile] = wt.reshape(tile, k * k).T
            for chunk in range(plan.grid[1]):
                for s in range(chunk * plan.stages, min(nst, (chunk + 1) * plan.stages)):
                    c0 = s * stage
                    halo = torch.zeros(th + k - 1, tw + k - 1, stage)  # zero past C, edge
                    part = src[bb, oy : oy + th + k - 1, ox : ox + tw + k - 1, c0 : c0 + stage]
                    halo[: part.shape[0], : part.shape[1], : part.shape[2]] = part.float()
                    acc = torch.zeros(th, tw, stage)
                    for i in range(k):
                        for j in range(k):
                            tap = ws[i * k + j, :tile].reshape(th, tw, 1)
                            acc += tap * halo[i : i + th, j : j + tw]
                    ny, nx = min(th, h - oy), min(tw, w - ox)
                    nc = min(stage, c - c0)
                    out[bb, oy : oy + ny, ox : ox + nx, c0 : c0 + nc] = acc[:ny, :nx, :nc]
    return out


def _inputs(seed, b, h, w, c, k):
    rng = np.random.RandomState(seed)
    src = rng.randn(b, h + k - 1, w + k - 1, c).astype(np.float32)
    ker = rng.rand(b, h, w, k, k).astype(np.float32)
    return src, ker / ker.sum(axis=(-2, -1), keepdims=True)


# (B, H, W, C, k): both routes at their edges (C 8 / 9, C 3 and 9 no multiple
# of 4), H and W no multiple of a tile, small and large k; a ragged wide
# shape; FeatUp's width at a small tile count; shapes the Pallas kernel takes
EMULATED = [(2, 19, 37, 3, 11), (2, 19, 37, 8, 15), (1, 13, 70, 1, 3), (2, 19, 37, 9, 1),
            (2, 19, 37, 9, 15), (2, 37, 53, 100, 5), (1, 16, 32, 384, 7),
            (1, 16, 32, 128, 11), (2, 16, 16, 256, 3)]


@pytest.mark.parametrize("shape", EMULATED, ids=lambda s: "x".join(map(str, s)))
def test_route_emulation_matches_plain_and_jax(shape):
    b, h, w, c, k = shape
    src, ker = _inputs(sum(shape), *shape)
    plan = _plan_k5(b, h, w, c, k, torch.float32)
    emulate = _emulate_narrow if plan.route == "narrow" else _emulate_wide
    got = emulate(torch.from_numpy(src), torch.from_numpy(ker), plan)
    ref = adaptive_conv_fused_ref(torch.from_numpy(src), torch.from_numpy(ker))
    torch.testing.assert_close(got, ref, **TOL)
    want = np.asarray(j_ac.adaptive_conv(jnp.asarray(src), jnp.asarray(ker)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if adaptive_conv_fused_applicable(h, w, c, k):
        pallas = j_adaptive_conv_fused(jnp.asarray(src), jnp.asarray(ker), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_wide_emulation_walks_chunks_of_several_stages_with_a_tail():
    """A shape whose blocks walk several 32-channel stages per chunk, the
    last chunk shorter and its last stage 8 channels wide."""
    shape = (2, 150, 150, 200, 3)
    b, h, w, c, k = shape
    plan = _plan_k5(b, h, w, c, k, torch.float32)
    assert plan.route == "wide" and plan.stages > 1
    assert plan.grid[1] * plan.stages > math.ceil(c / t_ac.WIDE_STAGE)
    src, ker = _inputs(5, *shape)
    got = _emulate_wide(torch.from_numpy(src), torch.from_numpy(ker), plan)
    want = np.asarray(j_ac.adaptive_conv(jnp.asarray(src), jnp.asarray(ker)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(2, 19, 37, 3, 11), (2, 19, 37, 100, 5)])
def test_route_emulation_bf16_source(shape):
    """bf16 source: the halo is widened to f32 as it is read, the weights are
    f32, the sum is f32 and the output is rounded to bf16, as the plain
    version does: the same sums in the same order, so the same bits."""
    b, h, w, c, k = shape
    src, ker = _inputs(3, *shape)
    src_b, ker_b = torch.from_numpy(src).bfloat16(), torch.from_numpy(ker).bfloat16()
    plan = _plan_k5(b, h, w, c, k, torch.bfloat16)
    emulate = _emulate_narrow if plan.route == "narrow" else _emulate_wide
    got = emulate(src_b, ker_b, plan).bfloat16()
    ref = adaptive_conv_fused_ref(src_b, ker_b)
    assert ref.dtype == torch.bfloat16
    assert torch.equal(got, ref)
