"""The host side of the tensor-core K2 (bf16, ``csrc/na2d_fused_q.cu`` on
``csrc/na_tc.cuh``), on the CPU: the plan it shares with K3
(``na2d_fused._plan_tc``) at K2's shapes, and a plain torch emulation of the
kernel's order of work:

    per 64-query tile of the launch's rows (a band: the global rows
    [y0, y0 + band_h), the pool rule and the RoPE row table global): each
    query pooled over its input window (a sum times 1 / count, in f32),
    RoPE'd with the f32 tables (the partner channel dh/2 away read from the
    whole channel row), rounded to bf16 into a d zero-padded to a multiple
    of 16 (zero rows past the grid); the K/V box (zero cells past urh * urw
    up to NB, keys bf16(k * scale), zero channels to 16); S = Q K^T in f32
    plus log(count) of each box cell in each query's window (-inf outside
    it); the softmax statistics as running max and sum over chunks of 128
    cells (boxes above 192 cells); P rounded to bf16 before P V; only the
    real dv channels stored, into a slab or a shared output in place.

In f32 it is held against the plain version (``naf_upsample_attention_ref``,
2e-4) and the JAX package's ``naf_upsample_attention`` on the same numpy
inputs: the Pallas kernel in interpret mode where its tiling takes the shape
(``pick_geometry``), else the JAX package's own plain path (``_fused_q_twin``,
what ``naf_tpu`` runs for shapes its kernel refuses); in bf16 against the f32
plain version at cosine > 0.9995. The CUDA kernel itself runs on the card
(``test_torch_card_fused_q.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.kernels import na2d_fused_q as t_q
from naf_torch.kernels.na2d_fused import PAD, TC_CHUNK, TC_NB, TC_TILES, _box, _pad_heads, _plan_tc
from naf_torch.kernels.na2d_fused_q import (
    _band,
    naf_upsample_attention,
    naf_upsample_attention_ref,
)
from naf_torch.nn.rope import rotate_half
from naf_torch.ops.window import cross_scale_lr_indices
from naf_tpu.kernels.na2d_fused_q import _fused_q_twin, pick_geometry
from naf_tpu.kernels.na2d_fused_q import naf_upsample_attention as j_fused_q
from naf_tpu.nn import RoPE as JRoPE

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _pool_sums(h_in: int, h_out: int, y0: int, rows: int, full_in: int, in0: int):
    """(rows, h_in) 0/1 windows of query rows [y0, y0 + rows) of an h_out-row
    grid over input rows from in0 on of a full_in-row grid, and each row's
    window size: the kernel's integer rule."""
    m = torch.zeros(rows, h_in)
    count = torch.zeros(rows)
    for i, y in enumerate(range(y0, y0 + rows)):
        lo = (y * full_in) // h_out - in0
        hi = -(-(y + 1) * full_in // h_out) - in0
        m[i, lo:hi] = 1.0
        count[i] = hi - lo
    return m, count


def _stats(s, chunk):
    """Row max and 1 / sum of exp(s - max), as a running max and sum over
    chunks of ``chunk`` cells."""
    m = torch.full(s.shape[:-1], -torch.inf)
    tot = torch.zeros(s.shape[:-1])
    for c0 in range(0, s.shape[-1], chunk):
        sc = s[..., c0 : c0 + chunk]
        mn = torch.maximum(m, sc.amax(-1))
        ms = torch.where(mn == -torch.inf, 0.0, mn)
        tot = tot * torch.exp(m - ms) + torch.exp(sc - ms[..., None]).sum(-1)
        m = mn
    m = torch.where(m == -torch.inf, 0.0, m)
    return m[..., None], torch.where(tot > 0, 1 / tot, 0.0)[..., None]


def _emulate(enc, keys, values, rt, ct, dh, n, ks, scale=None, bf16=False, row_cell0=0,
             band_cells=None, out_acc=None, enc_banded=False):
    """The tensor-core K2's order of work in torch, f32 in and out; with
    ``bf16`` the inputs are rounded to bf16 first (the card's inputs) and
    every operand where the kernel rounds. Returns the slab, or ``out_acc``
    with the band's rows written."""
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    enc, keys, values = rnd(enc), rnd(keys), rnd(values)
    b, hi, wi, c = enc.shape
    hq, wq = rt.shape[0], ct.shape[0]
    _, hk, wk, cv = values.shape
    d, dv = c // n, cv // n
    scale = d ** -0.5 if scale is None else scale
    y0, band_h, hi_full, enc_row0 = _band(enc.shape, hq, hk, row_cell0, band_cells, enc_banded)
    # the prologue: pool window sums times 1 / count, the partner channels
    # of the same pooled row, the f32 tables, bf16 into a zero-padded d
    ph, nh = _pool_sums(hi, hq, y0, band_h, hi_full, enc_row0)
    pw, nw = _pool_sums(wi, wq, 0, wq, wi, 0)
    sums = torch.einsum("oh,bhwc->bowc", ph, enc)
    sums = torch.einsum("ow,bhwc->bhoc", pw, sums)
    xp = sums * (1.0 / (nh[:, None] * nw[None, :]))[None, :, :, None]
    rtb = rt[y0 : y0 + band_h]
    cos = rtb[:, None, :c] * ct[None, :, :c]
    sin = rtb[:, None, c:] * ct[None, :, c:]
    q = xp * cos + rotate_half(xp, dh) * sin
    q = rnd(_pad_heads(q.reshape(b, band_h, wq, n, d), PAD["wgmma"]))
    k = rnd(_pad_heads(keys.reshape(b, hk, wk, n, d), PAD["wgmma"]) * scale)
    v = _pad_heads(values.reshape(b, hk, wk, n, dv), PAD["wgmma"])
    dp, dvp = q.shape[-1], v.shape[-1]
    rows = None if band_h == hq else (y0, y0 + band_h)
    tqh, tqw, urh, urw, nb, cnt_h, cnt_w, row_lo, col_lo = _plan_tc(
        hq, wq, hk, wk, ks, dp, dvp, False, "cpu", rows)
    chunk = nb if nb <= TC_NB[-1] else TC_CHUNK
    ncell = urh * urw
    out = torch.full((b, band_h, wq, n, dv), torch.nan)
    for tr in range(-(-band_h // tqh)):
        for tc in range(-(-wq // tqw)):
            ys = tr * tqh + torch.arange(64) // tqw  # rows of the band
            xs = tc * tqw + torch.arange(64) % tqw
            valid = (ys < band_h) & (xs < wq)
            yc, xc = ys.clamp(max=band_h - 1), xs.clamp(max=wq - 1)
            qt = torch.where(valid[None, :, None, None], q[:, yc, xc], 0.0)
            r0, c0 = int(row_lo[tr]), int(col_lo[tc])
            cells = torch.arange(nb)
            real = cells < ncell
            br, bc = (cells // urw).clamp(max=urh - 1), cells % urw
            kb = torch.where(real[None, :, None, None], k[:, r0 + br, c0 + bc], 0.0)
            vb = torch.where(real[None, :, None, None], v[:, r0 + br, c0 + bc], 0.0)
            s = torch.einsum("bqnd,bcnd->bnqc", qt, kb)
            m = cnt_h[yc][:, br].float() * cnt_w[xc][:, bc].float()
            m = torch.where(valid[:, None] & real[None, :], m, 0.0)
            s = torch.where(m > 0, s + torch.log(m.clamp(min=1)), -torch.inf)
            mx, inv = _stats(s, chunk)
            pb = rnd(torch.exp(s - mx) * inv)
            o = rnd(torch.einsum("bnqc,bcnv->bqnv", pb, vb))
            out[:, ys[valid], xs[valid]] = o[:, valid, :, :dv]  # the real channels only
    out = out.reshape(b, band_h, wq, cv)
    if out_acc is None:
        return out
    out_acc[:, y0 : y0 + band_h] = out
    return out_acc


def _inputs(hi, hq, hk, c, cv, rope_heads, seed=40):
    """enc (1, hi, hi, c), keys (1, hk, hk, c), values (1, hk, hk, cv) from
    numpy, and the JAX RoPE's cos|sin tables of an hq^2 output."""
    rng = np.random.RandomState(seed)
    jr = JRoPE(embed_dim=c, num_heads=rope_heads)
    jp = jr.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, c)))
    sin_r, cos_r, sin_c, cos_c = jr.apply(jp, hq, hq, method=jr.tables)
    return (rng.randn(1, hi, hi, c).astype(np.float32),
            rng.randn(1, hk, hk, c).astype(np.float32),
            rng.randn(1, hk, hk, cv).astype(np.float32),
            np.concatenate([cos_r, sin_r], -1), np.concatenate([cos_c, sin_c], -1),
            c // rope_heads)


# (encoder side, output side, LR side, C, Cv, attention heads, RoPE heads,
# k): identity pool, 2x pool-up, ragged pool-up with ragged windows (cells
# repeated in a window), the input guard's 4:1 pool-down, RoPE heads that
# straddle the attention heads, NAF(dim=96)'s d 24 (dh/2 = 12), dv 3 with
# one head, and a ratio-1 box of 16 x 16 cells (the chunked kernel)
SHAPES = {
    "identity": (64, 64, 16, 128, 96, 2, 2, 9),
    "pool-up": (32, 64, 16, 128, 96, 2, 2, 9),
    "ragged": (28, 60, 16, 128, 96, 2, 2, 9),
    "pool-down": (128, 32, 8, 128, 96, 2, 2, 5),
    "rope2-attn4": (32, 32, 8, 128, 96, 4, 2, 5),
    "c96-4heads": (16, 32, 8, 96, 96, 4, 4, 5),
    "dv3": (32, 32, 8, 96, 3, 1, 4, 5),
    "box256": (24, 24, 24, 64, 48, 2, 2, 9),
}


def _case(label):
    hi, hq, hk, c, cv, n, rope_heads, ks = SHAPES[label]
    arrays = _inputs(hi, hq, hk, c, cv, rope_heads)
    return arrays[:5], arrays[5], dict(num_heads=n, kernel_size=ks)


def _jax(arrays, dh, kw):
    """The JAX package's K2: its Pallas kernel in interpret mode where its
    tiling takes the shape, else its plain path for shapes it refuses."""
    enc, keys, values, rows, cols = arrays
    n, ks = kw["num_heads"], kw["kernel_size"]
    c, cv = enc.shape[-1], values.shape[-1]
    geom = pick_geometry(rows.shape[0], cols.shape[0], enc.shape[1], enc.shape[2],
                         keys.shape[1], keys.shape[2], ks, n, c // n, cv // n)
    ja = [jnp.asarray(a) for a in arrays]
    if geom is not None:
        return np.asarray(j_fused_q(*ja, dh, **kw, interpret=True))
    return np.asarray(_fused_q_twin(*ja, dh, n, ks, (c // n) ** -0.5))


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("label", list(SHAPES))
def test_k2_tc_emulation_matches_plain_and_jax_in_f32(label):
    arrays, dh, kw = _case(label)
    args = [torch.from_numpy(a) for a in arrays]
    got = _emulate(*args, dh, kw["num_heads"], kw["kernel_size"])
    torch.testing.assert_close(got, naf_upsample_attention_ref(*args, dh, **kw), **TOL)
    np.testing.assert_allclose(got.numpy(), _jax(arrays, dh, kw), **TOL)


@pytest.mark.parametrize("label", list(SHAPES))
def test_k2_tc_emulation_in_bf16_holds_the_cosine_bar(label):
    arrays, dh, kw = _case(label)
    args = [torch.from_numpy(a) for a in arrays]
    got = _emulate(*args, dh, kw["num_heads"], kw["kernel_size"], bf16=True)
    assert _cos(got, naf_upsample_attention_ref(*args, dh, **kw)) > 0.9995


def _band_case():
    """64^2 <- 16^2 at 2x pool-up (4 output rows per cell row, 2 per input
    row) and a band of the JAX kernel's cell block at cell row 4."""
    arrays, dh, kw = _case("pool-up")
    bc_h = pick_geometry(64, 64, 32, 32, 16, 16, 9, 2, 64, 48)[0]
    return arrays, dh, kw, dict(row_cell0=bc_h, band_cells=bc_h)


def test_k2_tc_emulation_of_a_slab_band_matches_plain_and_jax():
    arrays, dh, kw, band = _band_case()
    args = [torch.from_numpy(a) for a in arrays]
    got = _emulate(*args, dh, kw["num_heads"], kw["kernel_size"], **band)
    assert got.shape == (1, band["band_cells"] * 4, 64, 96)
    torch.testing.assert_close(got, naf_upsample_attention_ref(*args, dh, **kw, **band), **TOL)
    want = j_fused_q(*map(jnp.asarray, arrays), dh, **kw, interpret=True, **band)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    gotb = _emulate(*args, dh, kw["num_heads"], kw["kernel_size"], bf16=True, **band)
    assert _cos(gotb, naf_upsample_attention_ref(*args, dh, **kw, **band)) > 0.9995


def test_k2_tc_emulation_of_out_acc_with_enc_banded_leaves_other_rows():
    """The band's encoder rows alone, written into a shared output in place:
    the band's rows match the plain version and the JAX kernel, every other
    row keeps its value."""
    arrays, dh, kw, band = _band_case()
    c0, cells = band["row_cell0"], band["band_cells"]
    banded = list(arrays)
    banded[0] = arrays[0][:, c0 * 2 : (c0 + cells) * 2]  # 2 input rows per cell row
    args = [torch.from_numpy(a) for a in banded]
    acc = torch.full((1, 64, 64, 96), 7.0)
    got = _emulate(*args, dh, kw["num_heads"], kw["kernel_size"], **band, out_acc=acc,
                   enc_banded=True)
    assert got is acc
    y0, y1 = c0 * 4, (c0 + cells) * 4
    assert bool((acc[:, :y0] == 7.0).all()) and bool((acc[:, y1:] == 7.0).all())
    want = naf_upsample_attention_ref(*args, dh, **kw, **band, out_acc=torch.full_like(acc, 7.0),
                                      enc_banded=True)
    torch.testing.assert_close(acc, want, **TOL)
    jacc = j_fused_q(*map(jnp.asarray, banded), dh, **kw, interpret=True, **band,
                     out_acc=jnp.full((1, 64, 64, 96), 7.0, jnp.float32), enc_banded=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), **TOL)


# K2's shapes on the card: (Hq, hk, k, d, dv, band rows or None)
PLAN_SHAPES = [(448, 28, 9, 64, 96, None), (2048, 28, 9, 64, 96, None),
               (448, 28, 9, 32, 96, None), (448, 28, 9, 64, 256, None),
               (128, 128, 9, 64, 96, None), (2048, 128, 9, 64, 96, (768, 1024)),
               (4096, 256, 9, 64, 96, (2048, 2560))]


@pytest.mark.parametrize("hq,hk,ks,d,dv,rows", PLAN_SHAPES)
def test_k2_plan_boxes_and_counts(hq, hk, ks, d, dv, rows):
    """At K2's shapes (448^2, 448^2 -> 2048^2, NAF(dim=96)'s d padded to 32,
    dv 256, a ratio-1 box, the bands of NAF(band_rows) and naf_streamed):
    64-query tiles whose boxes hold every window cell of the launch's rows,
    count tables that sum to k, a box width the kernel takes, and a band's
    tables the band's rows of the whole grid's."""
    tqh, tqw, urh, urw, nb, cnt_h, cnt_w, row_lo, col_lo = _plan_tc(
        hq, hq, hk, hk, ks, d, dv, False, "cpu", rows)
    assert tqh * tqw == 64 and urh * urw <= nb
    assert nb in TC_NB or (nb % TC_CHUNK == 0 and nb * urw < 2**16)
    idx = cross_scale_lr_indices(hq, hk, ks)
    y0, y1 = rows or (0, hq)
    assert cnt_h.shape == (y1 - y0, urh) and cnt_w.shape == (hq, urw)
    for tile, lo, ext, cnt, ix in ((tqh, row_lo, urh, cnt_h, idx[y0:y1]),
                                   (tqw, col_lo, urw, cnt_w, idx)):
        lo, cnt = lo.numpy(), cnt.numpy()
        assert (cnt.sum(1) == ks).all()
        for y in range(ix.shape[0]):
            rel = ix[y] - lo[y // tile]
            np.testing.assert_array_equal(np.bincount(rel, minlength=ext), cnt[y])
    if rows is not None:
        full = _plan_tc(hq, hq, hk, hk, ks, d, dv, False, "cpu")
        torch.testing.assert_close(cnt_h, full[5][y0:y1])
    boxes = [_box(idx[y0:y1], th, hk)[1] * _box(idx, tw, hk)[1] for th, tw in TC_TILES]
    assert urh * urw == min(boxes) or nb == next((n for n in TC_NB if n >= min(boxes)), nb)


def test_k2_plan_at_the_main_path_and_2048():
    """448^2 <- 28^2: 8 x 8 tiles, a 9 x 9 box padded to 96; 2048^2 <- 28^2:
    tiles straddle LR cells (a box of at most 10 x 10 cells) and repeated
    cells count 2; a ratio-1 box at k 9 runs chunked."""
    plan = _plan_tc(448, 448, 28, 28, 9, 64, 96, False, "cpu")
    assert plan[:5] == (8, 8, 9, 9, 96)
    plan = _plan_tc(2048, 2048, 28, 28, 9, 64, 96, False, "cpu")
    assert plan[2] * plan[3] <= plan[4] <= 128 and int(plan[5].max()) == 2
    nb = _plan_tc(128, 128, 128, 128, 9, 64, 96, False, "cpu")[4]
    assert nb > TC_NB[-1] and nb % TC_CHUNK == 0


@pytest.mark.parametrize("hq,hk,rows,share", [
    (448, 28, None, 1.0), (2048, 28, None, 0.45), (64, 16, None, 0.25), (128, 128, None, 0.0),
    (2048, 128, (768, 1024), 1.0)])
def test_k2_uniform_tiles_run_first(hq, hk, rows, share):
    """The tiles the kernel takes as uniform (one window row of biases) are
    whole tiles whose count rows are all one, on both axes: every tile at
    448^2 <- 28^2 and in a band of 2048^2 <- 128^2 (ratio 16), about half
    at 2048^2 <- 28^2 (2 x 32 tiles, whose 32 columns straddle LR cells at a
    ratio of 73), a quarter at ratio 4, none at ratio 1. The blocks' order
    is a permutation of the tiles with those first, each group in order."""
    plan = t_q._plan_k2(hq, hq, hk, hk, 9, 64, 96, "cpu", rows)
    tqh, tqw, cnt_h, cnt_w, order, n_uniform = (plan[0], plan[1], plan[5], plan[6], plan[-2],
                                                 plan[-1])
    flags = []
    for tile, cnt in ((tqh, cnt_h), (tqw, cnt_w)):
        got = t_q._uniform_tiles(cnt, tile)
        assert got.shape == (-(-cnt.shape[0] // tile),) and got.dtype == torch.bool
        for i, f in enumerate(got.tolist()):
            rows_i = cnt[i * tile : (i + 1) * tile]
            assert f == (rows_i.shape[0] == tile and bool((rows_i == rows_i[:1]).all()))
        flags.append(got)
    uniform = (flags[0][:, None] & flags[1][None, :]).flatten()
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(uniform.numel()))
    assert n_uniform == int(uniform.sum()) and bool(uniform[order[:n_uniform].long()].all())
    assert not bool(uniform[order[n_uniform:].long()].any())
    for part in (order[:n_uniform], order[n_uniform:]):
        assert bool((part[1:] > part[:-1]).all())
    assert n_uniform / uniform.numel() >= share and (share > 0 or n_uniform == 0)


def test_k2_counts_launches_per_route():
    """CPU tensors run the plain version and count no launch; the counters
    have one slot per route."""
    arrays, dh, kw = _case("dv3")
    args = [torch.from_numpy(a).bfloat16() for a in arrays[:3]] + [
        torch.from_numpy(a) for a in arrays[3:]]
    before = (naf_upsample_attention.launches, dict(naf_upsample_attention.route_launches))
    naf_upsample_attention(*args, dh, **kw)
    assert set(naf_upsample_attention.route_launches) == {"wgmma", "fma", "fma_chunked"}
    assert (naf_upsample_attention.launches,
            dict(naf_upsample_attention.route_launches)) == before


def test_ablations_still_apply():
    """naf_torch.tools.ablate_fused_q's text edits match the sources."""
    from naf_torch.tools import ablate_fused_q

    sources = ablate_fused_q.edited_sources()
    assert set(sources) == set(ablate_fused_q.VARIANTS)
    for name, files in sources.items():
        assert (files == sources["as_built"]) == (name == "as_built")
