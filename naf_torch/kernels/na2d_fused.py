"""Fused cross-scale neighbourhood attention: kernels K3 (forward) and K4
(recompute-P backward), and their plain versions.

Counterpart of ``naf_tpu/kernels/na2d_fused.py`` (public entry
``cross_scale_na2d_fused``; kernels ``_fused_fwd_impl`` and
``_fused_bwd_impl``). Layouts are the JAX package's: q (B, Hq, Wq, n, d),
k (B, hk, wk, n, d), v (B, hk, wk, n, dv) -> (B, Hq, Wq, n, dv) in q's dtype.
The softmax scale is folded into the keys, as the JAX wrapper does; the
kernels fold it in as they stage the keys, rounding as the plain version
does.

``csrc/na2d_fused.cu`` holds both kernels, each in two routes chosen from
the dtype alone (:func:`_route`): bf16 on the tensor cores
(``csrc/na_tc.cuh``, "wgmma"), f32 on the CUDA cores ("fma"). The windows
come from the host-built tables of ``ops.window`` (natten's rule), so the
kernels take every ratio the oracle takes; for each tile of queries the host
also finds the box of LR cells its windows touch, which the kernels stage in
shared memory. The f32 route shrinks its tile until the box fits
(:func:`_plan`), and where no tile's whole box fits (one head of d 256 at
k 15) takes the chunked kernels, which walk the box in chunks of whole box
rows ("fma_chunked", :func:`_plan_fma`); the bf16 route takes 64-query
tiles, the shape with the smallest box (boxes above 192 cells in chunks of
128), and per-axis tables of how often each box cell occurs in each
query's window (:func:`_plan_tc`). Either raises where nothing fits. K4's
whole-box bf16 and chunked f32 launches run in bands of query rows where
their f32 box partials would exceed ``PARTIAL_BUDGET`` (:func:`_bwd_bands`).
The bf16 route's chunked boxes take FlashAttention-2's backward instead: K3
there also writes each query's f32 log-sum-exp, and K4 is two launches with
no partials, a query-major one for dq on K3's plan and a key-major one for
dk and dv, whose 64-key tiles walk the box of queries whose windows hold
their keys (:func:`_plan_kv`).

Widths the kernels do not take are padded, not refused: d and dv get zero
channels up to the route's multiple (:func:`_pad_heads`). Zero channels of q
and k leave the logits unchanged; zero channels of v and dO give zero
columns of out and dv, which are sliced off, as are those of dq and dk.

``cross_scale_na2d_fused`` is a ``torch.autograd.Function``: on CUDA tensors
its forward launches K3 and its backward launches K4 (counts in
``cross_scale_na2d_fused.launches`` and ``cross_scale_na2d_fused.bwd_launches``,
per route in ``cross_scale_na2d_fused.route_launches``: "wgmma_bwd" counts
every bf16 K4 call or band, "wgmma_chunked_bwd" those of them on the chunked
boxes' two launches); on the chunked bf16 route the forward saves K3's
output and log-sum-exp for the backward. On CPU tensors both
directions run the plain versions, the backward through the explicit
recompute-P formulas of the TPU kernel's ``_bwd_kernel``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from naf_torch.kernels import _build
from naf_torch.ops.na2d import cross_scale_na2d
from naf_torch.ops.window import cross_scale_lr_indices
from naf_torch.utils.spans import span, to_device

__all__ = [
    "cross_scale_na2d_fused",
    "cross_scale_na2d_fused_ref",
    "cross_scale_na2d_fused_bwd_ref",
]

# Query tiles of the f32 route, tried in order, largest first.
_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
SMEM_BUDGET = 100 * 1024  # two blocks per SM where the box allows it
SMEM_MAX = 227 * 1024
# The bf16 route's 64-query tiles (one warpgroup, wgmma's M), in order of
# preference among boxes of one size; its box widths NB (the kernels'
# NATC_NB_CASES), the chunk of the kernels that take larger boxes (natc::NBC:
# NB a multiple of it, NB * urw < 2^16), and the channel multiple of each
# route.
TC_TILES = ((8, 8), (4, 16), (16, 4), (2, 32), (32, 2), (1, 64), (64, 1))
TC_NB = (32, 64, 96, 128, 160, 192)
TC_CHUNK = 128
PAD = {"wgmma": 16, "fma": 4}
# Bytes of K4's f32 box partials one whole-box bf16 (or chunked f32) launch
# may write; above it K4 runs in bands of query rows, summing dk and dv over
# the bands in f32.
PARTIAL_BUDGET = 2**30
# Gathered K/V windows one row block of the plain backward may hold.
_ROW_BLOCK_BYTES = 256 * 2**20


def _scaled_keys(k, scale, dtype):
    """The keys with the softmax scale folded in, rounded to ``dtype``."""
    return (k.float() * scale).to(dtype)


def _pad_heads(t, mult: int):
    """t with zero channels appended to its last dim, up to a multiple of
    ``mult`` (t itself when it is one)."""
    extra = -t.shape[-1] % mult
    return torch.nn.functional.pad(t, (0, extra)) if extra else t


def _aligned(t):
    """t contiguous and 16-byte aligned (a copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _route(dtype) -> str:
    """Which kernels CUDA tensors of this dtype launch, decided from the
    dtype alone: bf16 the tensor-core ones ("wgmma"), f32 the CUDA-core ones
    ("fma")."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"K3/K4 take float32 or bfloat16, got {dtype}")


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _band_rows(q, k, row_cell0: int, full_hq):
    """(row0, full_hq) of a K3 call whose q holds the rows from LR cell row
    ``row_cell0`` on of a ``full_hq``-row query grid; (0, Hq) unbanded. A
    band must be whole cell rows of an integer row ratio."""
    hq, hk = q.shape[1], k.shape[1]
    if full_hq is None or (row_cell0 == 0 and full_hq == hq):
        if row_cell0:
            raise ValueError("row_cell0 needs full_hq")
        return 0, hq
    if full_hq % hk or hq % (full_hq // hk):
        raise ValueError(f"a banded call needs full_hq % hk == 0 and whole cell rows: "
                         f"full_hq {full_hq}, hk {hk}, band of {hq} rows")
    row0 = row_cell0 * (full_hq // hk)
    if row_cell0 < 0 or row0 + hq > full_hq:
        raise ValueError(f"band rows [{row0}, {row0 + hq}) outside the {full_hq}-row grid")
    return row0, full_hq


def cross_scale_na2d_fused_ref(q, k, v, kernel_size: int, scale=None, row_cell0: int = 0,
                               full_hq=None):
    """Plain version of K3: the oracle with the scale folded into the keys
    (as the kernel gets them). f32 logits and softmax; q's dtype out.
    ``row_cell0``/``full_hq``: q holds the query rows from LR cell row
    ``row_cell0`` on of a ``full_hq``-row grid (banded, windows global)."""
    row0, full = _band_rows(q, k, row_cell0, full_hq)
    ks = _scaled_keys(k, _scale(q, scale), k.dtype)
    out = cross_scale_na2d(q.float(), ks.float(), v.float(), kernel_size, scale=1.0,
                           row0=row0, full_hq=full)
    return out.to(q.dtype)


def cross_scale_na2d_fused_bwd_ref(q, k, v, dout, kernel_size: int, scale=None,
                                   row_cell0: int = 0, full_hq=None):
    """Plain version of K4: the recompute-P formulas of the TPU kernel's
    ``_bwd_kernel``, per row block of queries, in f32:

        P = softmax(scale * q.k_win);  dP = dO.v_win^T;  delta = rowsum(P * dP)
        dL = P * (dP - delta);  dq = scale * dL.k_win
        dk += scale * dL^T q;  dv += P^T dO   (scatter-added to the LR grid)

    ``row_cell0``/``full_hq`` as in :func:`cross_scale_na2d_fused_ref`: a
    band's windows are the band's rows of the global tables, its dq holds
    the band's rows, and dk, dv cover the whole LR grid, zero where no
    window of the band reaches. Returns (dq, dk, dv) in the dtypes of q, k
    and v."""
    scale = _scale(q, scale)
    b, hq, wq, n, d = q.shape
    _, hk, wk, _, dv = v.shape
    dev = q.device
    row0, full = _band_rows(q, k, row_cell0, full_hq)
    idx_h = cross_scale_lr_indices(full, hk, kernel_size)[row0 : row0 + hq]
    idx_h = to_device(np.ascontiguousarray(idx_h), dev)
    idx_w = to_device(cross_scale_lr_indices(wq, wk, kernel_size), dev)
    kf = k.float()
    vf = v.float()
    dk = torch.zeros(b, hk * wk, n, d, device=dev)
    dvv = torch.zeros(b, hk * wk, n, dv, device=dev)
    dq = torch.empty(b, hq, wq, n, d, device=dev)
    per_row = b * wq * kernel_size ** 2 * n * (d + dv) * 4
    row_block = max(min(_ROW_BLOCK_BYTES // max(per_row, 1), hq), 1)
    for i0 in range(0, hq, row_block):
        ih = idx_h[i0 : i0 + row_block]
        qb = q[:, i0 : i0 + row_block].float()
        gb = dout[:, i0 : i0 + row_block].float()
        kg = kf[:, ih][:, :, :, idx_w]  # (B, r, kh, Wq, kw, n, d)
        vg = vf[:, ih][:, :, :, idx_w]
        logits = torch.einsum("bijnd,bitjsnd->bijnts", qb, kg) * scale
        r = logits.shape[1]
        p = torch.softmax(logits.reshape(b, r, wq, n, -1), dim=-1)
        dp = torch.einsum("bijnd,bitjsnd->bijnts", gb, vg).reshape(p.shape)
        delta = (p * dp).sum(-1, keepdim=True)
        dl = (p * (dp - delta)).reshape(logits.shape)
        p = p.reshape(logits.shape)
        dq[:, i0 : i0 + r] = scale * torch.einsum("bijnts,bitjsnd->bijnd", dl, kg)
        # every (query, slot) contribution, scatter-added to its LR cell
        cell = (ih[:, :, None, None] * wk + idx_w[None, None]).reshape(-1)  # (r, kh, Wq, kw)
        ck = scale * torch.einsum("bijnts,bijnd->bitjsnd", dl, qb)
        cv = torch.einsum("bijnts,bijnd->bitjsnd", p, gb)
        dk.index_add_(1, cell, ck.reshape(b, -1, n, d))
        dvv.index_add_(1, cell, cv.reshape(b, -1, n, dv))
    return (dq.to(q.dtype), dk.reshape(b, hk, wk, n, d).to(k.dtype),
            dvv.reshape(b, hk, wk, n, dv).to(v.dtype))


def _box(idx: np.ndarray, tile: int, lr: int):
    """Per tile of ``tile`` queries on one axis: the first LR cell of a box
    of ``ext`` cells holding every window cell of the tile."""
    n_t = -(-idx.shape[0] // tile)
    lo = np.array([idx[i * tile : (i + 1) * tile].min() for i in range(n_t)])
    hi = np.array([idx[i * tile : (i + 1) * tile].max() for i in range(n_t)])
    ext = int((hi - lo).max()) + 1
    return np.minimum(lo, lr - ext).astype(np.int32), ext


def _tables(hq, wq, hk, wk, ks, rows=None):
    """int32 window tables (the rows [y0, y1) of idx_h where ``rows``)."""
    idx_h = cross_scale_lr_indices(hq, hk, ks).astype(np.int32)
    if rows is not None:
        idx_h = idx_h[rows[0] : rows[1]]
    return idx_h, cross_scale_lr_indices(wq, wk, ks).astype(np.int32)


def _fit_tile(smem_bytes, tiles, limits, idx_h, idx_w, hk, wk, ks, d, dv):
    """(tqh, tqw, urh, urw, row_lo, col_lo) of the first tile of ``tiles``
    whose whole box needs at most a limit of ``limits`` bytes (the limits
    in order), or None."""
    for limit in limits:
        for tqh, tqw in tiles:
            row_lo, urh = _box(idx_h, tqh, hk)
            col_lo, urw = _box(idx_w, tqw, wk)
            if smem_bytes(d, dv, ks, urh, urw) <= limit:
                return tqh, tqw, urh, urw, row_lo, col_lo
    return None


def _on(device, *arrays):
    return tuple(to_device(np.ascontiguousarray(a), device) for a in arrays)


@functools.lru_cache(maxsize=64)
def _plan(lib, smem, tiles, limits, hq, wq, hk, wk, ks, d, dv, device, rows=None):
    """Tile size, K/V box and window tables (on ``device``) of one kernel at
    one shape: the first tile of ``tiles`` (largest first) whose box needs at
    most a limit of ``limits`` bytes of shared memory, trying the limits in
    order. ``lib`` loads the kernel's library, whose function named ``smem``
    gives the bytes: ``smem(d, dv, ks, box_rows, box_cols)``. ``rows``
    (y0, y1) plans a band: the row tables and boxes are those of the global
    query rows [y0, y1) of the hq-row grid."""
    idx_h, idx_w = _tables(hq, wq, hk, wk, ks, rows)
    fit = _fit_tile(getattr(lib(), smem), tiles, limits, idx_h, idx_w, hk, wk, ks, d, dv)
    if fit is None:
        raise ValueError(f"no query tile fits shared memory by {smem} for d={d}, dv={dv}, k={ks}")
    tqh, tqw, urh, urw, row_lo, col_lo = fit
    return (tqh, tqw, urh, urw, *_on(device, idx_h, idx_w, row_lo, col_lo))


def _chunk_shape(fits, urh: int, urw: int):
    """(rows, cols) of the largest chunk of a urh x urw box for which
    ``fits(cells)`` holds (monotone in cells): whole box rows where one row
    fits, else part of one row; None where not even one cell fits."""
    if fits(urw):
        return max(r for r in range(1, urh + 1) if fits(r * urw)), urw
    cols = [c for c in range(1, urw) if fits(c)]
    return (1, max(cols)) if cols else None


@functools.lru_cache(maxsize=64)
def _plan_fma(lib, smem, chunk_smem, tiles, limits, hq, wq, hk, wk, ks, d, dv, device,
              rows=None):
    """The f32 route's plan: ("fma", :func:`_plan`'s plan) where some tile's
    whole box fits; else the chunked kernels, ("fma_chunked", the plan +
    (cr, cc)): the first tile of ``tiles`` whose box takes chunks of whole
    box rows under the last limit (``chunk_smem(d, dv, ks, queries,
    cells)`` bytes), else the last tile that takes a part of a row. Raises
    where not even a chunk of one cell fits."""
    idx_h, idx_w = _tables(hq, wq, hk, wk, ks, rows)
    lib_ = lib()
    if _fit_tile(getattr(lib_, smem), tiles, limits, idx_h, idx_w, hk, wk, ks, d, dv):
        return "fma", _plan(lib, smem, tiles, limits, hq, wq, hk, wk, ks, d, dv, device, rows)
    chunk_bytes = getattr(lib_, chunk_smem)
    fit = chunk = None
    for tqh, tqw in tiles:
        row_lo, urh = _box(idx_h, tqh, hk)
        col_lo, urw = _box(idx_w, tqw, wk)
        shape = _chunk_shape(
            lambda nc: chunk_bytes(d, dv, ks, tqh * tqw, nc) <= limits[-1], urh, urw)
        if shape is not None:
            fit, chunk = (tqh, tqw, urh, urw, row_lo, col_lo), shape
            if shape[1] == urw:
                break
    if fit is None:
        raise ValueError(f"no query tile fits shared memory by {chunk_smem}, not even in "
                         f"chunks of one cell, for d={d}, dv={dv}, k={ks}")
    tqh, tqw, urh, urw, row_lo, col_lo = fit
    return "fma_chunked", (tqh, tqw, urh, urw, *_on(device, idx_h, idx_w, row_lo, col_lo),
                           *chunk)


def _tc_smem(d: int, dv: int, nb: int, backward: bool) -> int:
    """Shared memory of one block of the bf16 K3 / K4 (``natc::smem_bytes``,
    ``natc::smem_bytes_chunked`` above TC_NB): tiles in 128-byte swizzle,
    ceil(cols / 64) blocks of rows x 128 bytes each, 1024-aligned: q and the
    K/V box (chunked: one chunk of it, and the f32 sums of out); K4 also dO
    and one tile for P^T, then dS^T. Chunked K4 (either launch): the block's
    64 rows of two operands, one chunk of the other two, the f32 sums of dq
    or dk and of dv, and lse and delta for a chunk of rows."""
    def tile(rows, cols):
        return -(-cols // 64) * rows * 128

    if nb > TC_NB[-1]:
        qkv = 1024 + tile(64, d) + tile(TC_CHUNK, d) + tile(TC_CHUNK, dv)
        if not backward:
            return qkv + 64 * dv * 4
        return qkv + tile(64, dv) + 64 * (d + dv) * 4 + 2 * TC_CHUNK * 4
    qkv = 1024 + tile(64, d) + tile(nb, d) + tile(nb, dv)
    if not backward:
        return qkv
    return qkv + tile(64, dv) + tile(-(-nb // 64) * 64, 64)


def _tc_nb(cells: int, urw: int):
    """The padded box width NB of a box of ``cells`` cells, ``urw`` wide:
    the least of TC_NB that holds it, else (chunked) a multiple of TC_CHUNK
    with NB * urw < 2^16; None where there is none."""
    nb = next((n for n in TC_NB if n >= cells), None)
    if nb is None:
        nb = -(-cells // TC_CHUNK) * TC_CHUNK
        if nb * urw >= 2**16:
            return None
    return nb


def _window_counts(idx: np.ndarray, lo: np.ndarray, tile: int, ext: int) -> np.ndarray:
    """(L, ext) uint8: how often each cell of its tile's box occurs in each
    query's window, on one axis (2 where a ragged ratio repeats a cell)."""
    rel = idx - lo[np.arange(idx.shape[0]) // tile][:, None]
    counts = np.zeros((idx.shape[0], ext), np.uint8)
    np.add.at(counts, (np.arange(idx.shape[0])[:, None], rel), 1)
    return counts


@functools.lru_cache(maxsize=64)
def _plan_tc(hq, wq, hk, wk, ks, d, dv, backward, device, rows=None):
    """Tile, box and count tables (on ``device``) of the bf16 route at one
    shape: of the 64-query tiles in TC_TILES, the first whose box pads to
    the smallest NB (:func:`_tc_nb`; above TC_NB the chunked kernels) and
    whose block fits SMEM_MAX. Returns (tqh, tqw, urh, urw, nb, cnt_h,
    cnt_w, row_lo, col_lo). ``rows`` (y0, y1) plans a band of the global
    query rows [y0, y1)."""
    idx_h = cross_scale_lr_indices(hq, hk, ks).astype(np.int32)
    if rows is not None:
        idx_h = idx_h[rows[0] : rows[1]]
    idx_w = cross_scale_lr_indices(wq, wk, ks).astype(np.int32)
    best = None
    for tqh, tqw in TC_TILES:
        row_lo, urh = _box(idx_h, tqh, hk)
        col_lo, urw = _box(idx_w, tqw, wk)
        nb = _tc_nb(urh * urw, urw)
        if nb is None or _tc_smem(d, dv, nb, backward) > SMEM_MAX:
            continue
        if best is None or nb < best[4]:
            best = (tqh, tqw, urh, urw, nb, row_lo, col_lo)
    if best is None:
        raise ValueError(f"the tensor-core route takes no 64-query tile at Hq={hq} <- hk={hk}, "
                         f"Wq={wq} <- wk={wk}, k={ks}, d={d}, dv={dv}: every box is too wide "
                         f"for the mask's division (NB * urw >= 2^16) or the block exceeds "
                         f"shared memory")
    tqh, tqw, urh, urw, nb, row_lo, col_lo = best
    to = lambda a: to_device(np.ascontiguousarray(a), device)
    return (tqh, tqw, urh, urw, nb, to(_window_counts(idx_h, row_lo, tqh, urh)),
            to(_window_counts(idx_w, col_lo, tqw, urw)), to(row_lo), to(col_lo))


def _query_box(idx: np.ndarray, tile: int, lr: int):
    """(lo, need, ext) of the tiles of ``tile`` LR cells on one axis (the
    keys): each tile's box of ``ext`` queries from query lo holds every
    query whose window holds one of the tile's cells, and the first
    ``need`` of them reach the last such query (0 where there is none)."""
    n_t = -(-lr // tile)
    first, last = np.zeros(n_t, np.int64), np.full(n_t, -1)
    for i in range(n_t):
        ys = np.flatnonzero(((idx >= i * tile) & (idx < (i + 1) * tile)).any(1))
        if ys.size:
            first[i], last[i] = ys[0], ys[-1]
    ext = max(int((last - first).max()) + 1, 1)
    lo = np.minimum(first, idx.shape[0] - ext)
    need = np.where(last >= 0, last - lo + 1, 0)
    return lo.astype(np.int32), need, ext


def _key_counts(idx: np.ndarray, lo: np.ndarray, tile: int, ext: int, lr: int) -> np.ndarray:
    """(lr, ext) uint8: how often each LR cell occurs in the window of each
    query of its tile's query box, on one axis (the transpose of
    :func:`_window_counts`)."""
    rows = idx[lo[:, None] + np.arange(ext)]  # (tiles, ext, k)
    cell = np.arange(lr)
    return (rows[cell // tile] == cell[:, None, None]).sum(-1).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _plan_kv(hq, wq, hk, wk, ks, device, rows=None):
    """The key-major plan of the chunked bf16 K4's dk/dv launch (tables on
    ``device``): of the 64-key tiles of the LR grid in TC_TILES, the first
    with the fewest chunks of TC_CHUNK cells to walk over all tiles. A
    tile's box of queries holds every query whose window holds one of its
    keys (of the band's rows where ``rows``); the boxes share one size, and
    a tile walks its box's rows from the first up to the last that holds
    such a query, whole rows (at the grid's edges natten's windows shift,
    and those tiles' boxes need a row more). Returns (tkh, tkw, qurh, qurw,
    nbk, cntt_h, cntt_w, qlo_r, qlo_c, walk): the tile, the box, its cells
    padded to chunks, the transposed count tables (hk, qurh) and (wk,
    qurw), each key tile row's and column's first query row and column, and
    the cells each key tile row walks."""
    idx_h, idx_w = _tables(hq, wq, hk, wk, ks, rows)
    best = None
    for tkh, tkw in TC_TILES:
        lo_r, need_r, ext_r = _query_box(idx_h, tkh, hk)
        lo_c, _, ext_c = _query_box(idx_w, tkw, wk)
        walk = -(-need_r * ext_c // TC_CHUNK) * TC_CHUNK
        work = int(walk.sum()) * lo_c.size
        if best is None or work < best[0]:
            best = (work, tkh, tkw, ext_r, ext_c, lo_r, lo_c, walk)
    _, tkh, tkw, qurh, qurw, lo_r, lo_c, walk = best
    nbk = -(-qurh * qurw // TC_CHUNK) * TC_CHUNK
    to = lambda a: to_device(np.ascontiguousarray(a), device)
    return (tkh, tkw, qurh, qurw, nbk, to(_key_counts(idx_h, lo_r, tkh, qurh, hk)),
            to(_key_counts(idx_w, lo_c, tkw, qurw, wk)), to(lo_r), to(lo_c),
            to(walk.astype(np.int32)))


@functools.cache
def _lib():
    lib = _build.load("na2d_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.naf_na_fwd_smem, lib.naf_na_bwd_smem, lib.naf_na_fwd_chunk_smem,
               lib.naf_na_bwd_chunk_smem):
        fn.argtypes = [i32] * 5
        fn.restype = ctypes.c_longlong
    lib.naf_na_tc_smem.argtypes = [i32] * 4
    lib.naf_na_tc_smem.restype = ctypes.c_longlong
    f32 = ctypes.c_float
    lib.naf_na_fwd_fma.argtypes = [ptr] * 8 + [f32] + [i32] * 13 + [ptr]
    lib.naf_na_bwd_fma.argtypes = [ptr] * 12 + [f32] + [i32] * 14 + [ptr]
    lib.naf_na_fwd_fma_chunked.argtypes = [ptr] * 8 + [f32] + [i32] * 15 + [ptr]
    lib.naf_na_bwd_fma_chunked.argtypes = [ptr] * 12 + [f32] + [i32] * 16 + [ptr]
    lib.naf_na_fwd_wgmma.argtypes = [ptr] * 9 + [f32] + [i32] * 13 + [ptr]
    lib.naf_na_bwd_wgmma.argtypes = [ptr] * 12 + [f32] + [i32] * 14 + [ptr]
    lib.naf_na_bwd_wgmma_chunked.argtypes = [ptr] * 18 + [f32] + [i32] * 18 + [ptr]
    for fn in (lib.naf_na_fwd_fma, lib.naf_na_bwd_fma, lib.naf_na_fwd_fma_chunked,
               lib.naf_na_bwd_fma_chunked, lib.naf_na_fwd_wgmma, lib.naf_na_bwd_wgmma,
               lib.naf_na_bwd_wgmma_chunked):
        fn.restype = i32
    return lib


def _check(q, k, v, *more):
    tensors = (q, k, v, *more)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("K3/K4 launch on CUDA tensors, all on one device")
    _route(q.dtype)
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError("q, k, v (and dO) must share one dtype")
    if q.ndim != 5 or k.ndim != 5 or v.ndim != 5:
        raise ValueError("K3/K4 take (B, H, W, heads, d) tensors")
    b, hq, wq, n, d = q.shape
    _, hk, wk, _, dv = v.shape
    if k.shape != (b, hk, wk, n, d) or v.shape[:4] != (b, hk, wk, n):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    return b, hq, wq, n, d, hk, wk, dv


def _operands(q, k, v, *more):
    """The kernels' operands: contiguous, 16-byte aligned, d and dv padded
    with zero channels to the route's multiple. Returns (route, q, k, v,
    *more) with ``more`` padded like v."""
    route = _route(q.dtype)
    return (route, *(_aligned(_pad_heads(t, PAD[route])) for t in (q, k, v, *more)))


def _launch_fwd(q, k, v, kernel_size, scale, row0: int = 0, full_hq=None):
    """Launch K3 on CUDA tensors; returns (B, Hq, Wq, n, dv) in q's dtype.
    A band (q = rows [row0, row0 + Hq) of a ``full_hq``-row grid) runs the
    same kernel on the band's rows of the global window tables."""
    out, _ = _fwd(q, k, v, kernel_size, scale, row0, full_hq)
    dv = v.shape[-1]
    return out[..., :dv] if out.shape[-1] != dv else out


def _fwd(q, k, v, kernel_size, scale, row0: int = 0, full_hq=None):
    """K3 as :func:`_launch_fwd` launches it: (out with the route's padded
    dv, lse). On the bf16 route's chunked boxes lse is each query's f32
    log-sum-exp of its window's logits (B, Hq, Wq, n), which the chunked K4
    reads; elsewhere None."""
    b, hq, wq, n, d, hk, wk, dv = _check(q, k, v)
    full = hq if full_hq is None else full_hq
    rows = None if full == hq else (row0, row0 + hq)
    route, qc, kc, vc = _operands(q, k, v)
    dp, dvp = qc.shape[-1], vc.shape[-1]
    out = torch.empty((b, hq, wq, n, dvp), dtype=q.dtype, device=q.device)
    lse = None
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr())
        if route == "wgmma":
            tqh, tqw, urh, urw, nb, cnt_h, cnt_w, row_lo, col_lo = _plan_tc(
                full, wq, hk, wk, kernel_size, dp, dvp, False, str(q.device), rows)
            if nb > TC_NB[-1]:
                lse = torch.empty((b, hq, wq, n), dtype=torch.float32, device=q.device)
            err = lib.naf_na_fwd_wgmma(
                *ptrs, cnt_h.data_ptr(), cnt_w.data_ptr(), row_lo.data_ptr(),
                col_lo.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
                scale, b, hq, wq, hk, wk, n, dp, dvp, tqh, tqw, urh, urw, nb, stream)
        else:
            route, plan = _plan_fma(_lib, "naf_na_fwd_smem", "naf_na_fwd_chunk_smem", _TILES,
                                    (SMEM_BUDGET, SMEM_MAX), full, wq, hk, wk, kernel_size, dp,
                                    dvp, str(q.device), rows)
            tqh, tqw, urh, urw, idx_h, idx_w, row_lo, col_lo, *chunk = plan
            fn = lib.naf_na_fwd_fma if route == "fma" else lib.naf_na_fwd_fma_chunked
            err = fn(*ptrs, idx_h.data_ptr(), idx_w.data_ptr(), row_lo.data_ptr(),
                     col_lo.data_ptr(), out.data_ptr(), scale, b, hq, wq, hk, wk, n, dp, dvp,
                     kernel_size, tqh, tqw, urh, urw, *chunk, stream)
    if err:
        raise RuntimeError(f"na2d_fused forward kernel ({route}) launch failed: cudaError {err}")
    cross_scale_na2d_fused.launches += 1
    cross_scale_na2d_fused.route_launches[route] += 1
    return out, lse


def _bwd_bands(b, hq, wq, n, dc, tqh, tqw, ncell):
    """The query-row bands [y0, y1) of K4's bf16 launches: the whole grid,
    unless its f32 box partials ((b, tiles, n, ncell, dc)) exceed
    PARTIAL_BUDGET; then as many whole rows of tiles per band as the budget
    holds (at least one)."""
    tile_row = b * -(-wq // tqw) * n * ncell * dc * 4
    if -(-hq // tqh) * tile_row <= PARTIAL_BUDGET:
        return [(0, hq)]
    rows = max(PARTIAL_BUDGET // tile_row, 1) * tqh
    return [(y0, min(y0 + rows, hq)) for y0 in range(0, hq, rows)]


def _bwd_launch(route, plan, q, k, v, g, dq, dk, dv, scale, kernel_size, add=False):
    """One launch of K4's tile kernel and reduce pass on prepared operands
    (q, g, dq the rows that ``plan`` tables); ``add``: dk, dv f32, the sums
    added to them."""
    b, hq, wq, n, dp = q.shape
    _, hk, wk, _, dvp = v.shape
    if route == "wgmma":
        tqh, tqw, urh, urw, nb, tab_h, tab_w, row_lo, col_lo = plan
    else:
        tqh, tqw, urh, urw, tab_h, tab_w, row_lo, col_lo, *chunk = plan
    tiles = -(-hq // tqh) * -(-wq // tqw)
    partial = torch.empty((b, tiles, n, urh * urw, dp + dvp), dtype=torch.float32,
                          device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), tab_h.data_ptr(),
                tab_w.data_ptr(), row_lo.data_ptr(), col_lo.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), partial.data_ptr(), scale, b, hq, wq, hk, wk, n,
                dp, dvp)
        if route == "wgmma":
            err = lib.naf_na_bwd_wgmma(*args, tqh, tqw, urh, urw, nb, int(add), stream)
        else:
            fn = lib.naf_na_bwd_fma if route == "fma" else lib.naf_na_bwd_fma_chunked
            err = fn(*args, kernel_size, tqh, tqw, urh, urw, *chunk, int(add), stream)
    if err:
        raise RuntimeError(f"na2d_fused backward kernel ({route}) launch failed: cudaError {err}")
    cross_scale_na2d_fused.bwd_launches += 1
    cross_scale_na2d_fused.route_launches[f"{route}_bwd"] += 1


def _bwd_plan(route, hq, wq, hk, wk, ks, dp, dvp, dev, rows=None):
    """(route, plan) of K4 on one band of query rows (all where None):
    bf16 the tensor-core kernels, f32 the whole-box kernel where a tile's
    box fits, else the chunked one."""
    if route == "wgmma":
        return route, _plan_tc(hq, wq, hk, wk, ks, dp, dvp, True, dev, rows)
    return _plan_fma(_lib, "naf_na_bwd_smem", "naf_na_bwd_chunk_smem", _TILES, (SMEM_MAX,), hq,
                     wq, hk, wk, ks, dp, dvp, dev, rows)


def _bwd_chunked(plan, q, k, v, g, stats, scale, kernel_size, row0, full, rows):
    """The bf16 K4 on chunked boxes, on prepared operands: the query-major
    launch (K3's ``plan``) writes dq, the key-major one (:func:`_plan_kv`)
    dk and dv, both from K3's padded output and lse (``stats``; one K3
    launch here where None). Returns (dq, dk, dv) with padded widths."""
    b, hq, wq, n, dp = q.shape
    _, hk, wk, _, dvp = v.shape
    out, lse = stats if stats is not None else _fwd(q, k, v, kernel_size, scale, row0, full)
    out = _aligned(out)
    tqh, tqw, urh, urw, nb, cnt_h, cnt_w, row_lo, col_lo = plan
    tkh, tkw, qurh, qurw, nbk, cntt_h, cntt_w, qlo_r, qlo_c, walk = _plan_kv(
        full, wq, hk, wk, kernel_size, str(q.device), rows)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().naf_na_bwd_wgmma_chunked(
            *(t.data_ptr() for t in (q, k, v, g, out, lse, cnt_h, cnt_w, row_lo, col_lo,
                                     cntt_h, cntt_w, qlo_r, qlo_c, walk, dq, dk, dvv)),
            scale, b, hq, wq, hk, wk, n, dp, dvp, tqh, tqw, urh, urw, nb, tkh, tkw, qurh, qurw,
            nbk, stream)
    if err:
        raise RuntimeError(f"na2d_fused chunked backward kernels (wgmma) launch failed: "
                           f"cudaError {err}")
    cross_scale_na2d_fused.bwd_launches += 1
    cross_scale_na2d_fused.route_launches["wgmma_bwd"] += 1
    cross_scale_na2d_fused.route_launches["wgmma_chunked_bwd"] += 1
    return dq, dk, dvv


def _launch_bwd(q, k, v, dout, kernel_size, scale, row0: int = 0, full_hq=None, stats=None):
    """Launch K4 on CUDA tensors; returns (dq, dk, dv) in q's / k's / v's
    dtype. The whole-box tensor-core route and the chunked f32 route run one
    launch per band of :func:`_bwd_bands` (a band's plan may take another
    f32 route: its boxes are those of its own rows); the bf16 chunked boxes
    take :func:`_bwd_chunked`'s two launches, from ``stats`` = (out, lse) of
    :func:`_fwd` where the caller has them. A band of a ``full_hq``-row
    grid (q, dout = rows [row0, row0 + Hq)) plans every launch on the global
    rows it holds, as K3's banded launch does; its dk and dv cover the whole
    LR grid."""
    b, hq, wq, n, d, hk, wk, dv = _check(q, k, v, dout)
    if dout.shape != (b, hq, wq, n, dv):
        raise ValueError(f"dO {tuple(dout.shape)} does not fit the output {(b, hq, wq, n, dv)}")
    full = hq if full_hq is None else full_hq
    rows = None if full == hq else (row0, row0 + hq)
    route, qc, kc, vc, gc = _operands(q, k, v, dout)
    dp, dvp = qc.shape[-1], vc.shape[-1]
    dev = str(q.device)
    route, plan = _bwd_plan(route, full, wq, hk, wk, kernel_size, dp, dvp, dev, rows)
    if route == "wgmma" and plan[4] > TC_NB[-1]:
        dq, dk, dvv = _bwd_chunked(plan, qc, kc, vc, gc, stats, scale, kernel_size, row0, full,
                                   rows)
        return dq[..., :d], dk[..., :d], dvv[..., :dv]
    bands = [(0, hq)]
    if route != "fma":
        bands = _bwd_bands(b, hq, wq, n, dp + dvp, plan[0], plan[1], plan[2] * plan[3])
    dq = torch.empty_like(qc)
    if len(bands) == 1:
        dk = torch.empty((b, hk, wk, n, dp), dtype=k.dtype, device=q.device)
        dvv = torch.empty((b, hk, wk, n, dvp), dtype=v.dtype, device=q.device)
        _bwd_launch(route, plan, qc, kc, vc, gc, dq, dk, dvv, scale, kernel_size)
    else:
        # bands in a fixed order, each adding its sums to f32 dk, dv
        dk = torch.zeros((b, hk, wk, n, dp), dtype=torch.float32, device=q.device)
        dvv = torch.zeros((b, hk, wk, n, dvp), dtype=torch.float32, device=q.device)
        for y0, y1 in bands:
            band_route, plan = _bwd_plan(route, full, wq, hk, wk, kernel_size, dp, dvp, dev,
                                         (row0 + y0, row0 + y1))
            dq_band = torch.empty_like(qc[:, y0:y1])
            _bwd_launch(band_route, plan, qc[:, y0:y1].contiguous(), kc, vc,
                        gc[:, y0:y1].contiguous(), dq_band, dk, dvv, scale, kernel_size, True)
            dq[:, y0:y1] = dq_band
        dk, dvv = dk.to(k.dtype), dvv.to(v.dtype)
    if dp == d and dvp == dv:
        return dq, dk, dvv
    return dq[..., :d], dk[..., :d], dvv[..., :dv]


class _FusedNA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kernel_size, scale, row_cell0, full_hq):
        ctx.meta = (kernel_size, scale, row_cell0, full_hq)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return cross_scale_na2d_fused_ref(q, k, v, kernel_size, scale, row_cell0, full_hq)
        out, lse = _fwd(q, k, v, kernel_size, scale, *_band_rows(q, k, row_cell0, full_hq))
        # the chunked K4 reads K3's statistics: its padded output and lse
        ctx.save_for_backward(q, k, v, *(() if lse is None else (out, lse)))
        dv = v.shape[-1]
        return out[..., :dv] if out.shape[-1] != dv else out

    @staticmethod
    def backward(ctx, g):
        kernel_size, scale, row_cell0, full_hq = ctx.meta
        q, k, v, *stats = ctx.saved_tensors
        with span("naf.attention.backward"):
            g = g.to(q.dtype)
            if q.device.type == "cpu":
                grads = cross_scale_na2d_fused_bwd_ref(q, k, v, g, kernel_size, scale,
                                                       row_cell0, full_hq)
            else:
                grads = _launch_bwd(q, k, v, g, kernel_size, scale,
                                    *_band_rows(q, k, row_cell0, full_hq), stats=stats or None)
        return (*grads, None, None, None, None)


def cross_scale_na2d_fused(q, k, v, kernel_size: int, scale=None, row_cell0: int = 0,
                           full_hq=None):
    """Cross-scale NA, differentiable. q (B, Hq, Wq, n, d), k (B, hk, wk, n, d),
    v (B, hk, wk, n, dv) -> (B, Hq, Wq, n, dv) in q's dtype; scale defaults to
    d**-0.5. CUDA tensors launch K3 forward and K4 backward; CPU tensors run
    the plain versions.

    Banded execution: q holds the query rows from LR cell row ``row_cell0``
    on of a ``full_hq``-row grid, and the windows follow the global grid. A
    band is differentiable (the JAX package's banded kernel is not): K4 runs
    on the band's rows, dq is the band's rows of the whole grid's dq, and dk,
    dv are the band's share of the whole grid's, so the bands of a partition
    of the rows sum to them."""
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel size must be odd, got {kernel_size}")
    full = q.shape[1] if full_hq is None else int(full_hq)
    _band_rows(q, k, row_cell0, full)
    return _FusedNA.apply(q, k, v, kernel_size, _scale(q, scale), int(row_cell0), full)


cross_scale_na2d_fused.launches = 0
cross_scale_na2d_fused.bwd_launches = 0
cross_scale_na2d_fused.route_launches = dict.fromkeys(
    ("wgmma", "fma", "fma_chunked", "wgmma_bwd", "wgmma_chunked_bwd", "fma_bwd",
     "fma_chunked_bwd"), 0)
