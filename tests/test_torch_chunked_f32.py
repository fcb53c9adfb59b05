"""The chunked f32 route of K2, K3 and K4 ("fma_chunked", ``csrc/na_fma.cuh``)
on the CPU: the planner (``na2d_fused._plan_fma``) with the kernels'
shared-memory sums (``SmemFormulas``, held to the libraries on the card),
and a plain torch emulation of the chunked kernels' order of work:

    per tile of queries its K/V box (``_box``), walked in chunks of whole box
    rows (or part of one row); pass 1 keeps per query a running max m and
    sum l of exp(logit - m) over its window slots in each chunk (K4 also the
    running sum of exp(logit - m) * dP, whose ratio to l is delta); pass 2
    computes P = exp(logit - m) / l exactly, chunk by chunk, adding P V to
    out (K2, K3), or dL = P (dP - delta) . K to dq and each chunk's box
    partials dK = scale dL^T q, dV = P^T dO (K4), summed per LR cell over
    the tiles in tile order by the reduce pass.

Held against the plain versions (2e-4 forward, 2e-3 gradients) and JAX's
``cross_scale_na2d`` with its ``jax.vjp``. The kernels themselves run on the
card (``test_torch_card_denoise.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.kernels.na2d_fused import (
    SMEM_BUDGET,
    SMEM_MAX,
    _TILES,
    _box,
    _plan,
    _plan_fma,
    cross_scale_na2d_fused_bwd_ref,
    cross_scale_na2d_fused_ref,
)
from naf_torch.kernels.na2d_fused_q import _TILES as K2_TILES
from naf_torch.kernels.na2d_fused_q import naf_upsample_attention_ref
from naf_torch.nn.rope import rotate_half
from naf_torch.ops.pool import adaptive_avg_pool2d
from naf_torch.ops.window import cross_scale_lr_indices
from naf_tpu.ops.na2d import cross_scale_na2d as j_cross_scale_na2d
from test_torch_card_denoise import SmemFormulas

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
GTOL = dict(atol=2e-3, rtol=2e-3)
LIB = lambda: SmemFormulas  # noqa: E731  (the planner takes a loader)

# the three kernels' planner arguments: (smem, chunk smem, tiles, limits)
KERNELS = {
    "k2": ("naf_fused_q_smem", "naf_fused_q_chunk_smem", K2_TILES, (SMEM_BUDGET, SMEM_MAX)),
    "k3": ("naf_na_fwd_smem", "naf_na_fwd_chunk_smem", _TILES, (SMEM_BUDGET, SMEM_MAX)),
    "k4": ("naf_na_bwd_smem", "naf_na_bwd_chunk_smem", _TILES, (SMEM_MAX,)),
}


def _plan_of(kernel, hq, hk, ks, d, dv, limits=None):
    smem, chunk_smem, tiles, default = KERNELS[kernel]
    return _plan_fma(LIB, smem, chunk_smem, tiles, limits or default, hq, hq, hk, hk, ks, d, dv,
                     "cpu")


def _whole_fits(kernel, hq, hk, ks, d, dv):
    smem, _, tiles, limits = KERNELS[kernel]
    try:
        _plan(LIB, smem, tiles, limits, hq, hq, hk, hk, ks, d, dv, "cpu")
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("hq,hk,ks,d,dv", [
    (448, 28, 9, 64, 96), (448, 448, 15, 256, 4), (448, 448, 15, 256, 3), (64, 64, 15, 256, 4),
    (448, 448, 9, 256, 4), (448, 448, 11, 128, 4), (448, 448, 15, 96, 4), (448, 448, 7, 256, 4),
    (64, 32, 11, 64, 192), (64, 32, 13, 64, 192), (32, 16, 9, 64, 192), (100, 28, 9, 64, 96),
    (448, 448, 15, 512, 16)])
def test_chunked_exactly_where_the_whole_box_plan_raises(kernel, hq, hk, ks, d, dv):
    route, plan = _plan_of(kernel, hq, hk, ks, d, dv)
    assert route == ("fma" if _whole_fits(kernel, hq, hk, ks, d, dv) else "fma_chunked")
    smem, chunk_smem, _, limits = KERNELS[kernel]
    tqh, tqw, urh, urw = plan[:4]
    if route == "fma":
        assert len(plan) == 8 and getattr(SmemFormulas, smem)(d, dv, ks, urh, urw) <= limits[-1]
        return
    cr, cc = plan[8:]
    assert 1 <= cr <= urh and 1 <= cc <= urw and (cc == urw or cr == 1)
    assert getattr(SmemFormulas, chunk_smem)(d, dv, ks, tqh * tqw, cr * cc) <= limits[-1]
    # the chunk is the largest of its kind that fits
    bigger = (cr + 1) * cc if cc == urw else cr * (cc + 1)
    if (cr < urh if cc == urw else cc < urw):
        assert getattr(SmemFormulas, chunk_smem)(d, dv, ks, tqh * tqw, bigger) > limits[-1]


def test_the_denoisers_shape_is_chunked_on_all_three_kernels():
    """One head of d 256 at k 15, ratio 1: no tile's whole box fits (K2 needs
    259,296 bytes for one query's box, K3 263,728), so each takes chunks of
    whole box rows."""
    assert SmemFormulas.naf_fused_q_smem(256, 3, 15, 15, 15) > SMEM_MAX
    assert SmemFormulas.naf_na_fwd_smem(256, 4, 15, 15, 15) > SMEM_MAX
    for kernel, dv in (("k2", 3), ("k3", 4), ("k4", 4)):
        route, plan = _plan_of(kernel, 448, 448, 15, 256, dv)
        assert route == "fma_chunked" and plan[9] == plan[3], (kernel, plan[:4], plan[8:])


def test_the_planner_raises_where_not_one_cell_fits():
    with pytest.raises(ValueError, match="not even in chunks of one cell"):
        _plan_of("k4", 64, 64, 15, 256, 4, limits=(4096,))


def _emulate(q, k, v, ks, scale, tile, chunk, dout=None):
    """The chunked kernels' order of work in torch, f32 (see the module
    docstring). q (b, hq, wq, 1, d), k (b, hk, wk, 1, d), v (b, hk, wk, 1,
    dv); tile (tqh, tqw), chunk (cr, cc). Returns out, or (dq, dk, dv)."""
    b, hq, wq, _, d = q.shape
    _, hk, wk, _, dv = v.shape
    tqh, tqw = tile
    cr, cc = chunk
    idx_h = cross_scale_lr_indices(hq, hk, ks)
    idx_w = cross_scale_lr_indices(wq, wk, ks)
    row_lo, urh = _box(idx_h, tqh, hk)
    col_lo, urw = _box(idx_w, tqw, wk)
    q, k, v = q[..., 0, :], k[..., 0, :] * scale, v[..., 0, :]
    out = torch.zeros(b, hq, wq, dv)
    dq, dk, dvv = torch.zeros(b, hq, wq, d), torch.zeros(b, hk, wk, d), torch.zeros(b, hk, wk, dv)
    for tr in range(len(row_lo)):
        for tc in range(len(col_lo)):
            r0, c0 = int(row_lo[tr]), int(col_lo[tc])
            ys, xs = np.meshgrid(np.arange(tr * tqh, min((tr + 1) * tqh, hq)),
                                 np.arange(tc * tqw, min((tc + 1) * tqw, wq)), indexing="ij")
            ys, xs = ys.ravel(), xs.ravel()
            rows = torch.from_numpy(idx_h[ys])[:, :, None]  # (nq, ks, 1) LR rows of the slots
            cols = torch.from_numpy(idx_w[xs])[:, None, :]  # (nq, 1, ks)
            qt = q[:, ys, xs]  # (b, nq, d)
            kw, vw = k[:, rows, cols], v[:, rows, cols]  # (b, nq, ks, ks, c)
            s = torch.einsum("bqd,bqtsd->bqts", qt, kw)
            chunks = [(ra, ca) for ra in range(0, urh, cr) for ca in range(0, urw, cc)]
            inside = [((rows - r0 >= ra) & (rows - r0 < ra + cr)
                       & (cols - c0 >= ca) & (cols - c0 < ca + cc)) for ra, ca in chunks]
            if dout is not None:
                gt = dout[:, ys, xs, 0]
                dp = torch.einsum("bqv,bqtsv->bqts", gt, vw)
            # pass 1: running statistics over the chunks
            m = torch.full((b, len(ys)), -torch.inf)
            tot, dacc = torch.zeros(b, len(ys)), torch.zeros(b, len(ys))
            for msk in inside:
                sc = torch.where(msk, s, -torch.inf)
                mn = torch.maximum(m, sc.amax((-2, -1)))
                ms = torch.where(mn == -torch.inf, 0.0, mn)
                e = torch.exp(sc - ms[..., None, None])
                f = torch.exp(m - ms)
                tot = tot * f + e.sum((-2, -1))
                if dout is not None:
                    dacc = dacc * f + (e * dp).sum((-2, -1))
                m = mn
            delta = dacc / tot
            # pass 2: exact P per chunk
            part_k, part_v = torch.zeros(b, urh, urw, d), torch.zeros(b, urh, urw, dv)
            for msk in inside:
                p = torch.where(msk, torch.exp(s - m[..., None, None]) / tot[..., None, None], 0.0)
                if dout is None:
                    out[:, ys, xs] += torch.einsum("bqts,bqtsv->bqv", p, vw)
                    continue
                dl = p * (dp - delta[..., None, None])
                dq[:, ys, xs] += torch.einsum("bqts,bqtsd->bqd", dl, kw)
                cells = ((rows - r0) * urw + (cols - c0)).expand(-1, ks, ks).reshape(-1)
                ck = scale * torch.einsum("bqts,bqd->bqtsd", dl, qt).reshape(b, -1, d)
                cv = torch.einsum("bqts,bqv->bqtsv", p, gt).reshape(b, -1, dv)
                part_k.view(b, -1, d).index_add_(1, cells, ck)
                part_v.view(b, -1, dv).index_add_(1, cells, cv)
            if dout is not None:  # the reduce pass: tile order
                dk[:, r0 : r0 + urh, c0 : c0 + urw] += part_k
                dvv[:, r0 : r0 + urh, c0 : c0 + urw] += part_v
    if dout is None:
        return out[..., None, :]
    return dq[..., None, :], dk[..., None, :], dvv[..., None, :]


def _qkv(hq, hk, d, dv, seed=40, b=1):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(b, h, h, 1, c).astype(np.float32))
                 for h, c in ((hq, d), (hk, d), (hk, dv), (hq, dv)))


# (hq, hk, k, d, dv, tile, chunk): ratio 1 at k 15 (the denoiser's window),
# ratio 2, the ragged 26 <- 13 (repeated cells), chunks of part of a row
EMULATED = [(24, 24, 15, 16, 3, (8, 8), (4, 22)), (32, 16, 9, 16, 4, (4, 4), (2, 11)),
            (26, 13, 9, 8, 4, (4, 8), (3, 12)), (20, 20, 9, 16, 4, (2, 2), (1, 4))]


@pytest.mark.parametrize("hq,hk,ks,d,dv,tile,chunk", EMULATED)
def test_chunked_emulation_matches_plain_and_jax(hq, hk, ks, d, dv, tile, chunk):
    q, k, v, g = _qkv(hq, hk, d, dv)
    scale = d ** -0.5
    got = _emulate(q, k, v, ks, scale, tile, chunk)
    torch.testing.assert_close(got, cross_scale_na2d_fused_ref(q, k, v, ks), **TOL)
    grads = _emulate(q, k, v, ks, scale, tile, chunk, dout=g)
    for a, w in zip(grads, cross_scale_na2d_fused_bwd_ref(q, k, v, g, ks)):
        torch.testing.assert_close(a, w, **GTOL)
    fn = lambda a, b_, c: j_cross_scale_na2d(a, b_, c, ks)  # noqa: E731
    j_out, vjp = jax.vjp(fn, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out), **TOL)
    for a, w in zip(grads, vjp(jnp.asarray(g.numpy()))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GTOL)


def test_chunked_k2_emulation_matches_plain():
    """K2's chunked kernel: the pooled, RoPE'd queries (per chunk, as the
    plain version forms them), then the chunked attention."""
    rng = np.random.RandomState(41)
    hi, hq, hk, ks, c, cv = 12, 24, 24, 15, 16, 3
    enc = torch.from_numpy(rng.randn(1, hi, hi, c).astype(np.float32))
    keys = torch.from_numpy(rng.randn(1, hk, hk, c).astype(np.float32))
    values = torch.from_numpy(rng.randn(1, hk, hk, cv).astype(np.float32))
    rt, ct = (torch.from_numpy(rng.rand(hq, 2 * c).astype(np.float32)) for _ in range(2))
    want = naf_upsample_attention_ref(enc, keys, values, rt, ct, c, num_heads=1, kernel_size=ks)
    xu = adaptive_avg_pool2d(enc, (hq, hq))
    q = (xu * (rt[:, None, :c] * ct[None, :, :c])
         + rotate_half(xu, c) * (rt[:, None, c:] * ct[None, :, c:]))
    got = _emulate(q[..., None, :], keys[..., None, :], values[..., None, :], ks, c ** -0.5,
                   (8, 8), (5, 22))
    torch.testing.assert_close(got[..., 0, :], want, **TOL)


def test_bounds_ablation_still_applies():
    """naf_torch.tools.ablate_fma_bounds's edits match the kernels' source:
    each variant changes the three chunked kernels' bounds and nothing
    else."""
    from naf_torch.tools import ablate_fma_bounds as tool

    sources = tool.edited_sources()
    assert set(sources) == set(tool.VARIANTS)
    built = sources["as_built"]
    for variant, bounds in tool.VARIANTS.items():
        for name, text in sources[variant].items():
            if bounds is None:
                assert text == built[name]
                continue
            for kernel in tool.KERNELS:
                assert f"__launch_bounds__(THREADS, 1)\n{kernel}(" not in text
            assert len(text) == len(built[name]) + sum(
                len(f"__launch_bounds__{bounds}") - len("__launch_bounds__(THREADS, 1)")
                for kernel in tool.KERNELS if f"\n{kernel}(" in built[name])
