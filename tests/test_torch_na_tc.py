"""The host side of the tensor-core K3/K4 (bf16, ``csrc/na_tc.cuh``), on the
CPU: the planner's 64-query tiles, boxes and per-axis window-count tables
(``_plan_tc``), and a plain torch emulation of the kernels' order of work:

    per tile: the 64 queries (zero rows past the grid), the K/V box (zero
    cells past urh * urw up to NB, keys scaled and rounded as staged), zero
    channels up to the route's multiple; S = Q K^T in f32; + log(count) of
    each box cell in each query's window (-inf outside it); an f32 softmax;
    P rounded to bf16 before P V; K4's dP, delta, dS, dq and the tile's box
    partials dK = scale dS^T Q, dV = P^T dO, summed per LR cell in tile order.
    On boxes above 192 cells K4 is two launches fed by K3's log-sum-exp and
    delta = rowsum(dO * O): dq per query tile (P = exp(S - lse)), dk and dv
    per 64-key tile over its box of queries (``_plan_kv``: the transposed
    count tables, the cells each key tile row walks).

In f32 it is held against the plain versions (2e-4 forward, 2e-3 gradients)
and, at integer ratios, against the JAX Pallas kernels in interpret mode; in
bf16 against the f32 plain versions at cosine > 0.9995. The ragged ratios
(100 <- 28, 26 <- 13 at k = 9) repeat LR cells in a window; the JAX kernel
takes integer ratios only, so there the plain version is the oracle.

The CUDA kernels themselves run on the card (``test_torch_card_na.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.kernels import na2d_fused as t_na
from naf_torch.kernels.na2d_fused import (
    PAD,
    TC_CHUNK,
    TC_NB,
    TC_TILES,
    _bwd_bands,
    _pad_heads,
    _plan_kv,
    _plan_tc,
    _route,
    _tc_nb,
    cross_scale_na2d_fused_bwd_ref,
    cross_scale_na2d_fused_ref,
)
from naf_torch.ops.window import cross_scale_lr_indices
from naf_tpu.kernels.na2d_fused import cross_scale_na2d_fused as j_fused_na

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
GTOL = dict(atol=2e-3, rtol=2e-3)


def _stats(s, chunk):
    """Row max and 1 / sum of exp(s - max) over the box, kept as the kernels
    keep them: a running max and sum over chunks of ``chunk`` cells."""
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


def _emulate(q, k, v, ks, scale, dout=None, bf16=False, full_hq=None, rows=None,
             with_lse=False):
    """The tensor-core kernels' order of work in torch. q, k, v, dout are
    f32; with ``bf16`` they are rounded to bf16 first (the card's inputs) and
    every operand is rounded where the kernels round. Returns out (with
    ``with_lse`` also each query's log-sum-exp, (b, hq, wq, n)), or (dq, dk,
    dv) with ``dout``, in f32. ``rows`` (y0, y1): q and dout are those rows
    of a ``full_hq``-row grid, one band of K4, whose dk and dv come back as
    unrounded f32 sums on the whole-box route."""
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    b, hq, wq, n, d = q.shape
    _, hk, wk, _, dv = v.shape
    backward = dout is not None
    if backward and _plan_tc(full_hq or hq, wq, hk, wk, ks, -(-d // 16) * 16,
                             -(-dv // 16) * 16, True, "cpu", rows)[4] > TC_NB[-1]:
        return _emulate_two_roles(q, k, v, ks, scale, dout, bf16, full_hq, rows)
    q, k, v = (rnd(_pad_heads(t, PAD["wgmma"])) for t in (q, k, v))
    dp, dvp = q.shape[-1], v.shape[-1]
    tqh, tqw, urh, urw, nb, cnt_h, cnt_w, row_lo, col_lo = _plan_tc(
        full_hq or hq, wq, hk, wk, ks, dp, dvp, backward, "cpu", rows)
    chunk = nb if nb <= TC_NB[-1] else TC_CHUNK
    ks_ = rnd(k * scale)
    if backward:
        g = rnd(_pad_heads(dout, PAD["wgmma"]))
        dq = torch.zeros_like(q)
        dk = torch.zeros(b, hk, wk, n, dp)
        dvv = torch.zeros(b, hk, wk, n, dvp)
    else:
        out = torch.zeros(b, hq, wq, n, dvp)
        lse = torch.zeros(b, hq, wq, n)
    ncell = urh * urw
    for tr in range(-(-hq // tqh)):
        for tc in range(-(-wq // tqw)):
            # the tile's 64 query rows, row-major; rows past the grid are zero
            ys = tr * tqh + torch.arange(64) // tqw
            xs = tc * tqw + torch.arange(64) % tqw
            valid = (ys < hq) & (xs < wq)
            yc, xc = ys.clamp(max=hq - 1), xs.clamp(max=wq - 1)
            qt = torch.where(valid[None, :, None, None], q[:, yc, xc], 0.0)  # (b, 64, n, dp)
            r0, c0 = int(row_lo[tr]), int(col_lo[tc])
            cells = torch.arange(nb)
            real = cells < ncell
            br, bc = (cells // urw).clamp(max=urh - 1), (cells % urw)
            kb = torch.where(real[None, :, None, None], ks_[:, r0 + br, c0 + bc], 0.0)
            vb = torch.where(real[None, :, None, None], v[:, r0 + br, c0 + bc], 0.0)
            s = torch.einsum("bqnd,bcnd->bnqc", qt, kb)
            m = (cnt_h[yc][:, br].float() * cnt_w[xc][:, bc].float())
            m = torch.where(valid[:, None] & real[None, :], m, 0.0)
            s = torch.where(m > 0, s + torch.log(m.clamp(min=1)), -torch.inf)
            mx, inv = _stats(s, chunk)
            pb = rnd(torch.exp(s - mx) * inv)
            if not backward:
                o = rnd(torch.einsum("bnqc,bcnv->bqnv", pb, vb))
                out[:, ys[valid], xs[valid]] = o[:, valid]
                lse[:, ys[valid], xs[valid]] = (mx - torch.log(inv))[..., 0].transpose(1, 2)[
                    :, valid]
                continue
            gt = torch.where(valid[None, :, None, None], g[:, yc, xc], 0.0)
            dpp = torch.einsum("bqnv,bcnv->bnqc", gt, vb)
            delta = (pb * dpp).sum(-1, keepdim=True)
            ds = rnd(pb * (dpp - delta))
            dq[:, ys[valid], xs[valid]] = rnd(torch.einsum("bnqc,bcnd->bqnd", ds, kb))[:, valid]
            # the tile's box partials, added per LR cell in tile order
            part_k = scale * torch.einsum("bnqc,bqnd->bcnd", ds, qt)[:, :ncell]
            part_v = torch.einsum("bnqc,bqnv->bcnv", pb, gt)[:, :ncell]
            rr, cc = r0 + br[:ncell], c0 + bc[:ncell]
            dk[:, rr, cc] += part_k
            dvv[:, rr, cc] += part_v
    if not backward:
        return (out[..., :dv], lse) if with_lse else out[..., :dv]
    if rows is not None:
        return dq[..., :d], dk[..., :d], dvv[..., :dv]
    return dq[..., :d], rnd(dk[..., :d]), rnd(dvv[..., :dv])


def _emulate_two_roles(q, k, v, ks, scale, dout, bf16=False, full_hq=None, rows=None):
    """The chunked K4's two launches in torch, from K3's emulated output and
    log-sum-exp: delta = rowsum(dO * O) in f32; the query-major launch per
    tile of K3's plan: P = exp(S + log count - lse), dS = P (dP - delta)
    rounded, dq = dS K; the key-major launch per 64-key tile of
    ``_plan_kv``: the walked cells of its query box, S^T = K Q^T + log of
    the transposed counts, P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta),
    dv = bf16(P^T) dO, dk = scale bf16(dS^T) Q, each rounded once. A band's
    dk and dv are its queries' share."""
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    b, hq, wq, n, d = q.shape
    _, hk, wk, _, dv = v.shape
    full = full_hq or hq
    out, lse = _emulate(q, k, v, ks, scale, bf16=bf16, full_hq=full_hq, rows=rows,
                        with_lse=True)
    q, k, v, g = (rnd(_pad_heads(t, PAD["wgmma"])) for t in (q, k, v, dout))
    dp, dvp = q.shape[-1], v.shape[-1]
    delta = (g[..., :dv] * out).sum(-1)  # (b, hq, wq, n)
    ks_ = rnd(k * scale)
    tqh, tqw, urh, urw, nb, cnt_h, cnt_w, row_lo, col_lo = _plan_tc(
        full, wq, hk, wk, ks, dp, dvp, True, "cpu", rows)
    dq = torch.zeros_like(q)
    for tr in range(-(-hq // tqh)):
        for tc in range(-(-wq // tqw)):
            ys = tr * tqh + torch.arange(64) // tqw
            xs = tc * tqw + torch.arange(64) % tqw
            valid = (ys < hq) & (xs < wq)
            yc, xc = ys.clamp(max=hq - 1), xs.clamp(max=wq - 1)
            r0, c0 = int(row_lo[tr]), int(col_lo[tc])
            cells = torch.arange(urh * urw)
            br, bc = cells // urw, cells % urw
            s = torch.einsum("bqnd,bcnd->bnqc", q[:, yc, xc], ks_[:, r0 + br, c0 + bc])
            m = cnt_h[yc][:, br].float() * cnt_w[xc][:, bc].float()
            s = torch.where(m > 0, s + torch.log(m.clamp(min=1)), -torch.inf)
            p = torch.exp(s - lse[:, yc, xc].transpose(1, 2)[..., None])
            dpp = torch.einsum("bqnv,bcnv->bnqc", g[:, yc, xc], v[:, r0 + br, c0 + bc])
            ds = rnd(p * (dpp - delta[:, yc, xc].transpose(1, 2)[..., None]))
            dqt = rnd(torch.einsum("bnqc,bcnd->bqnd", ds, ks_[:, r0 + br, c0 + bc]))
            dq[:, ys[valid], xs[valid]] = dqt[:, valid]
    tkh, tkw, qurh, qurw, nbk, cntt_h, cntt_w, qlo_r, qlo_c, walk = _plan_kv(
        full, wq, hk, wk, ks, "cpu", rows)
    assert qurh * qurw <= nbk and nbk % TC_CHUNK == 0
    dk = torch.zeros(b, hk, wk, n, dp)
    dvv = torch.zeros(b, hk, wk, n, dvp)
    for tr in range(-(-hk // tkh)):
        for tc in range(-(-wk // tkw)):
            kr = tr * tkh + torch.arange(64) // tkw
            kc = tc * tkw + torch.arange(64) % tkw
            valid = (kr < hk) & (kc < wk)
            krc, kcc = kr.clamp(max=hk - 1), kc.clamp(max=wk - 1)
            cells = torch.arange(min(int(walk[tr]), qurh * qurw))
            qr, qc = int(qlo_r[tr]) + cells // qurw, int(qlo_c[tc]) + cells % qurw
            s = torch.einsum("bknd,bcnd->bnkc", ks_[:, krc, kcc], q[:, qr, qc])
            m = cntt_h[krc][:, cells // qurw].float() * cntt_w[kcc][:, cells % qurw].float()
            m = torch.where(valid[:, None], m, 0.0)
            s = torch.where(m > 0, s + torch.log(m.clamp(min=1)), -torch.inf)
            p = torch.exp(s - lse[:, qr, qc].transpose(1, 2)[:, :, None])
            dpp = torch.einsum("bknv,bcnv->bnkc", v[:, krc, kcc], g[:, qr, qc])
            ds = rnd(p * (dpp - delta[:, qr, qc].transpose(1, 2)[:, :, None]))
            dvt = rnd(torch.einsum("bnkc,bcnv->bknv", rnd(p), g[:, qr, qc]))
            dkt = rnd(scale * torch.einsum("bnkc,bcnd->bknd", ds, q[:, qr, qc]))
            dk[:, kr[valid], kc[valid]] = dkt[:, valid]
            dvv[:, kr[valid], kc[valid]] = dvt[:, valid]
    return dq[..., :d], dk[..., :d], dvv[..., :dv]


def _qkv(hq, hk, n=2, d=16, dv=24, seed=30, b=1):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(b, h, h, n, c).astype(np.float32))
                 for h, c in ((hq, d), (hk, d), (hk, dv), (hq, dv)))


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


# (Hq, hk, k, heads, d, dv): integer ratios, ragged ratios with repeated
# cells, the denoiser's dv = 3, a tile past the grid's edge; boxes above 192
# cells, run in chunks (K4 in its two launches): ratio 2 at k 11, ratio 1 at
# k 9 and at the denoiser's k 15 (one head, dv 3; its key tiles at the
# grid's edges walk a longer box) and the ragged 50 <- 40 at k 13
SHAPES = [(48, 12, 5, 2, 16, 24), (32, 16, 9, 2, 16, 24), (100, 28, 9, 1, 16, 24),
          (26, 13, 9, 2, 16, 24), (48, 12, 5, 1, 16, 3), (20, 10, 5, 3, 8, 1),
          (16, 16, 9, 1, 16, 3), (64, 32, 11, 2, 16, 24), (24, 24, 9, 2, 16, 24),
          (40, 40, 15, 1, 32, 3), (50, 40, 13, 2, 16, 24)]
CHUNKED = SHAPES[7:]


@pytest.mark.parametrize("hq,hk,ks,n,d,dv", SHAPES)
def test_tc_emulation_matches_plain_in_f32(hq, hk, ks, n, d, dv):
    q, k, v, g = _qkv(hq, hk, n, d, dv)
    scale = d ** -0.5
    torch.testing.assert_close(_emulate(q, k, v, ks, scale),
                               cross_scale_na2d_fused_ref(q, k, v, ks), **TOL)
    want = cross_scale_na2d_fused_bwd_ref(q, k, v, g, ks)
    for got, w in zip(_emulate(q, k, v, ks, scale, g), want):
        torch.testing.assert_close(got, w, **GTOL)


@pytest.mark.parametrize("hq,hk,ks", [(48, 12, 5), (32, 16, 9)])
def test_tc_emulation_matches_pallas(hq, hk, ks):
    """At integer ratios, against the TPU kernels run in interpret mode."""
    import jax

    q, k, v, g = _qkv(hq, hk)
    j = [jnp.asarray(t.numpy()) for t in (q, k, v)]
    want, vjp = jax.vjp(lambda *a: j_fused_na(*a, ks, interpret=True), *j)
    scale = 16 ** -0.5
    np.testing.assert_allclose(_emulate(q, k, v, ks, scale).numpy(), np.asarray(want), **TOL)
    for got, w in zip(_emulate(q, k, v, ks, scale, g), vjp(jnp.asarray(g.numpy()))):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GTOL)


@pytest.mark.parametrize("hq,hk,ks,n,d,dv", [SHAPES[1], SHAPES[2], SHAPES[4], SHAPES[6],
                                             *CHUNKED])
def test_tc_emulation_in_bf16_holds_the_cosine_bar(hq, hk, ks, n, d, dv):
    q, k, v, g = _qkv(hq, hk, n, d, dv)
    scale = d ** -0.5
    assert _cos(_emulate(q, k, v, ks, scale, bf16=True),
                cross_scale_na2d_fused_ref(q, k, v, ks)) > 0.9995
    want = cross_scale_na2d_fused_bwd_ref(q, k, v, g, ks)
    for got, w in zip(_emulate(q, k, v, ks, scale, g, bf16=True), want):
        assert _cos(got, w) > 0.9995


@pytest.mark.parametrize("hq,hk,ks", [(448, 28, 9), (32, 16, 9), (100, 28, 9), (2048, 28, 9),
                                      (26, 13, 9), (448, 28, 7), (20, 10, 5)])
def test_tc_plan_boxes_and_counts(hq, hk, ks):
    """Every box holds every window cell of its tile's queries; the count
    tables, summed over the box, give k per query and axis, and each
    query's window over its box is its table row (repeats counted); the
    tile is the 64-query shape with the smallest box."""
    for backward in (False, True):
        tqh, tqw, urh, urw, nb, cnt_h, cnt_w, row_lo, col_lo = _plan_tc(
            hq, hq, hk, hk, ks, 64, 96, backward, "cpu")
        assert tqh * tqw == 64 and nb in TC_NB and urh * urw <= nb < urh * urw + 32
        idx = cross_scale_lr_indices(hq, hk, ks)
        for tile, lo, ext, cnt in ((tqh, row_lo, urh, cnt_h), (tqw, col_lo, urw, cnt_w)):
            lo, cnt = lo.numpy(), cnt.numpy()
            assert cnt.shape == (hq, ext) and (cnt.sum(1) == ks).all()
            for y in range(hq):
                rel = idx[y] - lo[y // tile]
                assert ((rel >= 0) & (rel < ext)).all()
                np.testing.assert_array_equal(np.bincount(rel, minlength=ext), cnt[y])
        boxes = [t_na._box(idx, th, hk)[1] * t_na._box(idx, tw, hk)[1] for th, tw in TC_TILES]
        assert urh * urw == min(boxes) or nb == next(n for n in TC_NB if n >= min(boxes))


def test_tc_plan_counts_repeated_cells_and_bands():
    """100 <- 28 and 2048 <- 28 repeat a cell in some windows (count 2); a
    band plans the band's rows of the global tables."""
    assert int(_plan_tc(100, 100, 28, 28, 9, 64, 96, False, "cpu")[5].max()) == 2
    assert int(_plan_tc(2048, 2048, 28, 28, 9, 64, 96, False, "cpu")[5].max()) == 2
    full = _plan_tc(448, 448, 28, 28, 9, 64, 96, False, "cpu")
    band = _plan_tc(448, 448, 28, 28, 9, 64, 96, False, "cpu", (128, 192))
    assert band[:5] == full[:5]
    torch.testing.assert_close(band[5], full[5][128:192])
    torch.testing.assert_close(band[7], full[7][128 // full[0] : 192 // full[0]])


@pytest.mark.parametrize("hq,hk,ks", [(64, 64, 9), (64, 64, 15), (64, 32, 11), (64, 32, 15)])
def test_tc_plan_chunks_large_boxes(hq, hk, ks):
    """Boxes above 192 cells (ratio 1 from k = 7, ratio 2 from k = 11) pad
    to a multiple of the chunk, within the mask's division, and still hold
    every window cell of their tile."""
    for backward in (False, True):
        tqh, tqw, urh, urw, nb, cnt_h, cnt_w, row_lo, col_lo = _plan_tc(
            hq, hq, hk, hk, ks, 64, 192, backward, "cpu")
        assert tqh * tqw == 64 and urh * urw > TC_NB[-1]
        assert nb % TC_CHUNK == 0 and urh * urw <= nb < urh * urw + TC_CHUNK
        assert nb * urw < 2**16 and nb == _tc_nb(urh * urw, urw)
        assert (cnt_h.sum(1) == ks).all() and (cnt_w.sum(1) == ks).all()
        assert t_na._tc_smem(64, 192, nb, backward) <= t_na.SMEM_MAX


def test_tc_plan_raises_where_no_tile_fits():
    """k = 41 at ratio 1: every 64-query tile's box is too wide for the
    mask's division, and there is no fallback."""
    with pytest.raises(ValueError, match="tensor-core route takes no 64-query tile"):
        _plan_tc(64, 64, 64, 64, 41, 64, 96, False, "cpu")
    with pytest.raises(ValueError, match="tensor-core route"):  # shared memory
        _plan_tc(448, 448, 28, 28, 9, 512, 512, True, "cpu")


def test_bwd_bands_cover_the_rows_within_the_budget(monkeypatch):
    """K4's bands: whole rows of tiles, in order, covering every query row,
    each band's partials within the budget; one band under it."""
    assert _bwd_bands(4, 32, 32, 4, 256, 4, 16, 120) == [(0, 32)]
    tile_row = 1 * -(-448 // 8) * 4 * 81 * 160 * 4
    monkeypatch.setattr(t_na, "PARTIAL_BUDGET", 5 * tile_row + 1)
    bands = _bwd_bands(1, 448, 448, 4, 160, 8, 8, 81)
    assert bands[0][0] == 0 and bands[-1][1] == 448 and len(bands) == 12
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    assert all((y1 - y0) % 8 == 0 and (y1 - y0) // 8 <= 5 for y0, y1 in bands[:-1])
    monkeypatch.setattr(t_na, "PARTIAL_BUDGET", 1)  # below one row of tiles
    assert _bwd_bands(1, 20, 20, 1, 32, 4, 16, 40) == [(0, 4), (4, 8), (8, 12), (12, 16),
                                                      (16, 20)]


@pytest.mark.parametrize("hq,hk,ks,n,d,dv", [SHAPES[1], SHAPES[2], SHAPES[6], *CHUNKED])
def test_tc_emulation_of_banded_k4_matches_plain(hq, hk, ks, n, d, dv):
    """K4 in bands of query rows, each planned on its own rows of the global
    tables (the chunked boxes' key-major launch on the band's queries), dk
    and dv summed over the bands in f32, against the plain version (f32,
    2e-3)."""
    q, k, v, g = _qkv(hq, hk, n, d, dv)
    scale = d ** -0.5
    mid = 8 + (hq - 8) // 2
    bands = [(0, 8), (8, mid), (mid, hq)]
    dq, dk, dvv = torch.zeros_like(q), 0.0, 0.0
    for y0, y1 in bands:
        gq, gk, gv = _emulate(q[:, y0:y1], k, v, ks, scale, g[:, y0:y1], full_hq=hq,
                              rows=(y0, y1))
        dq[:, y0:y1] = gq
        dk, dvv = dk + gk, dvv + gv
    for got, w in zip((dq, dk, dvv), cross_scale_na2d_fused_bwd_ref(q, k, v, g, ks)):
        torch.testing.assert_close(got, w, **GTOL)


def _brute_key_boxes(idx, tile, lr, lo, ext, cnt, walk=None, width=1):
    """Each LR cell's tile box, from the window table alone: it holds every
    query whose window holds the cell, the transposed count table is how
    often the cell occurs in each box query's window, and (``walk``, rows
    of ``width`` cells) the walked cells reach the last such query."""
    lo, cnt = lo.numpy(), cnt.numpy()
    nq = idx.shape[0]
    assert cnt.shape == (lr, ext) and (lo >= 0).all() and (lo + ext <= nq).all()
    for r in range(lr):
        t = r // tile
        counts = (idx == r).sum(1)  # (nq,)
        ys = np.flatnonzero(counts)
        assert ((ys >= lo[t]) & (ys < lo[t] + ext)).all(), (r, ys, lo[t], ext)
        np.testing.assert_array_equal(cnt[r], counts[lo[t] : lo[t] + ext])
        if walk is not None and ys.size:
            assert (ys[-1] - lo[t] + 1) * width <= int(walk[t])


@pytest.mark.parametrize("hq,hk,ks,rows", [(64, 64, 9, None), (64, 64, 15, None),
                                           (448, 448, 15, None), (64, 32, 11, None),
                                           (50, 40, 13, None), (100, 28, 9, None),
                                           (64, 16, 15, None), (64, 64, 15, (16, 40)),
                                           (50, 40, 13, (10, 30))])
def test_kv_plan_inverts_the_window_tables(hq, hk, ks, rows):
    """The key-major plan of the chunked K4 against a brute-force inversion
    of ``cross_scale_lr_indices``: every 64-key tile's box of queries holds
    every query whose window holds one of its keys (the band's rows where
    ``rows``), the transposed count tables are the windows' counts, the
    cells each key tile row walks reach its last such query, and the walk is
    whole chunks within the padded box."""
    tkh, tkw, qurh, qurw, nbk, cntt_h, cntt_w, qlo_r, qlo_c, walk = _plan_kv(
        hq, hq, hk, hk, ks, "cpu", rows)
    assert tkh * tkw == 64 and qurh * qurw <= nbk < qurh * qurw + TC_CHUNK
    assert walk.shape == (-(-hk // tkh),) and (walk % TC_CHUNK == 0).all()
    assert (walk <= nbk).all()
    idx = cross_scale_lr_indices(hq, hk, ks)
    idx_h = idx if rows is None else idx[rows[0] : rows[1]]
    _brute_key_boxes(idx_h, tkh, hk, qlo_r, qurh, cntt_h, walk, qurw)
    _brute_key_boxes(idx, tkw, hk, qlo_c, qurw, cntt_w)


def test_lse_of_the_forward_is_the_windows_logsumexp():
    """K3's emulated log-sum-exp over its chunks is the plain log-sum-exp of
    each query's window logits (with repeated cells counted)."""
    hq, hk, ks, n, d, dv = SHAPES[10]
    q, k, v, _ = _qkv(hq, hk, n, d, dv)
    scale = d ** -0.5
    _, lse = _emulate(q, k, v, ks, scale, with_lse=True)
    idx = torch.from_numpy(cross_scale_lr_indices(hq, hk, ks).astype(np.int64))
    ks_ = k * scale
    kg = ks_[:, idx][:, :, :, idx]  # (b, hq, k, wq, k, n, d)
    logits = torch.einsum("bijnd,bitjsnd->bijnts", q, kg).reshape(1, hq, hq, n, -1)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), **TOL)


def test_route_is_the_dtype_alone():
    assert _route(torch.bfloat16) == "wgmma" and _route(torch.float32) == "fma"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _route(torch.float16)
    assert PAD == {"wgmma": 16, "fma": 4}


def test_ablations_still_apply():
    """naf_torch.tools.ablate_na_tc's text edits match the core's source."""
    from naf_torch.tools import ablate_na_tc

    sources = ablate_na_tc.edited_sources()
    assert set(sources) == set(ablate_na_tc.VARIANTS)
    assert all((text == sources["as_built"]) == (name == "as_built")
               for name, text in sources.items())
