"""Fused cross-scale neighbourhood attention: kernels K3 (forward) and K4
(recompute-P backward), and their plain versions.

Counterpart of ``naf_tpu/kernels/na2d_fused.py`` (public entry
``cross_scale_na2d_fused``; kernels ``_fused_fwd_impl`` and
``_fused_bwd_impl``). Layouts are the JAX package's: q (B, Hq, Wq, n, d),
k (B, hk, wk, n, d), v (B, hk, wk, n, dv) -> (B, Hq, Wq, n, dv) in q's dtype.
The softmax scale is folded into the keys, as the JAX wrapper does.

``csrc/na2d_fused.cu`` holds both kernels. The windows come from the
host-built tables of ``ops.window`` (natten's rule), so the kernels take every
ratio the oracle takes; for each tile of queries the host also finds the box
of LR cells its windows touch, which the kernels stage in shared memory. The
tile shrinks until its box fits; K4 raises where not even one query fits.

``cross_scale_na2d_fused`` is a ``torch.autograd.Function``: on CUDA tensors
its forward launches K3 and its backward launches K4 (counts in
``cross_scale_na2d_fused.launches`` and ``cross_scale_na2d_fused.bwd_launches``);
on CPU tensors both directions run the plain versions, the backward through
the explicit recompute-P formulas of the TPU kernel's ``_bwd_kernel``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from naf_torch.kernels import _build
from naf_torch.ops.na2d import cross_scale_na2d
from naf_torch.ops.window import cross_scale_lr_indices

__all__ = [
    "cross_scale_na2d_fused",
    "cross_scale_na2d_fused_ref",
    "cross_scale_na2d_fused_bwd_ref",
]

# Query tiles tried in order, largest first.
_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
SMEM_BUDGET = 100 * 1024  # two blocks per SM where the box allows it
SMEM_MAX = 227 * 1024
# Gathered K/V windows one row block of the plain backward may hold.
_ROW_BLOCK_BYTES = 256 * 2**20


def _scaled_keys(k, scale, dtype):
    """The keys with the softmax scale folded in, rounded to ``dtype``."""
    return (k.float() * scale).to(dtype)


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


def cross_scale_na2d_fused_bwd_ref(q, k, v, dout, kernel_size: int, scale=None):
    """Plain version of K4: the recompute-P formulas of the TPU kernel's
    ``_bwd_kernel``, per row block of queries, in f32:

        P = softmax(scale * q.k_win);  dP = dO.v_win^T;  delta = rowsum(P * dP)
        dL = P * (dP - delta);  dq = scale * dL.k_win
        dk += scale * dL^T q;  dv += P^T dO   (scatter-added to the LR grid)

    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    scale = _scale(q, scale)
    b, hq, wq, n, d = q.shape
    _, hk, wk, _, dv = v.shape
    dev = q.device
    idx_h = torch.from_numpy(cross_scale_lr_indices(hq, hk, kernel_size)).to(dev)
    idx_w = torch.from_numpy(cross_scale_lr_indices(wq, wk, kernel_size)).to(dev)
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


@functools.lru_cache(maxsize=64)
def _plan(lib, smem, tiles, limits, hq, wq, hk, wk, ks, d, dv, device, rows=None):
    """Tile size, K/V box and window tables (on ``device``) of one kernel at
    one shape: the first tile of ``tiles`` (largest first) whose box needs at
    most a limit of ``limits`` bytes of shared memory, trying the limits in
    order. ``lib`` loads the kernel's library, whose function named ``smem``
    gives the bytes: ``smem(d, dv, ks, box_rows, box_cols)``. ``rows``
    (y0, y1) plans a band: the row tables and boxes are those of the global
    query rows [y0, y1) of the hq-row grid."""
    smem_bytes = getattr(lib(), smem)
    idx_h = cross_scale_lr_indices(hq, hk, ks).astype(np.int32)
    if rows is not None:
        idx_h = idx_h[rows[0] : rows[1]]
    idx_w = cross_scale_lr_indices(wq, wk, ks).astype(np.int32)
    for limit in limits:
        for tqh, tqw in tiles:
            row_lo, urh = _box(idx_h, tqh, hk)
            col_lo, urw = _box(idx_w, tqw, wk)
            if smem_bytes(d, dv, ks, urh, urw) <= limit:
                to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                return (tqh, tqw, urh, urw, to(idx_h), to(idx_w), to(row_lo), to(col_lo))
    raise ValueError(f"no query tile fits shared memory by {smem} for d={d}, dv={dv}, k={ks}")


@functools.cache
def _lib():
    lib = _build.load("na2d_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.naf_na_fwd_smem, lib.naf_na_bwd_smem):
        fn.argtypes = [i32] * 5
        fn.restype = ctypes.c_longlong
    lib.naf_na_fwd.argtypes = [ptr] * 8 + [i32] * 14 + [ptr]
    lib.naf_na_fwd.restype = i32
    lib.naf_na_bwd.argtypes = [ptr] * 12 + [ctypes.c_float] + [i32] * 14 + [ptr]
    lib.naf_na_bwd.restype = i32
    return lib


def _check(q, k, v, *more):
    tensors = (q, k, v, *more)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("K3/K4 launch on CUDA tensors, all on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3/K4 take float32 or bfloat16, got {q.dtype}")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError("q, k, v (and dO) must share one dtype")
    if q.ndim != 5 or k.ndim != 5 or v.ndim != 5:
        raise ValueError("K3/K4 take (B, H, W, heads, d) tensors")
    b, hq, wq, n, d = q.shape
    _, hk, wk, _, dv = v.shape
    if k.shape != (b, hk, wk, n, d) or v.shape[:4] != (b, hk, wk, n):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if d % 4 or dv % 4:
        raise ValueError(f"K3/K4 need d % 4 == 0 and dv % 4 == 0, got d={d}, dv={dv}")
    return b, hq, wq, n, d, hk, wk, dv


def _launch_fwd(q, k, v, kernel_size, scale, row0: int = 0, full_hq=None):
    """Launch K3 on CUDA tensors; returns (B, Hq, Wq, n, dv) in q's dtype.
    A band (q = rows [row0, row0 + Hq) of a ``full_hq``-row grid) runs the
    same kernel on the band's rows of the global window tables."""
    b, hq, wq, n, d, hk, wk, dv = _check(q, k, v)
    full = hq if full_hq is None else full_hq
    tqh, tqw, urh, urw, idx_h, idx_w, row_lo, col_lo = _plan(
        _lib, "naf_na_fwd_smem", _TILES, (SMEM_BUDGET, SMEM_MAX), full, wq, hk, wk, kernel_size,
        d, dv, str(q.device), None if full == hq else (row0, row0 + hq))
    qc, kc, vc = q.contiguous(), _scaled_keys(k, scale, k.dtype).contiguous(), v.contiguous()
    out = torch.empty((b, hq, wq, n, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().naf_na_fwd(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), idx_h.data_ptr(), idx_w.data_ptr(),
            row_lo.data_ptr(), col_lo.data_ptr(), out.data_ptr(), b, hq, wq, hk, wk, n, d, dv,
            kernel_size, tqh, tqw, urh, urw, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"na2d_fused forward kernel launch failed: cudaError {err}")
    cross_scale_na2d_fused.launches += 1
    return out


def _launch_bwd(q, k, v, dout, kernel_size, scale):
    """Launch K4 on CUDA tensors; returns (dq, dk, dv) in q's / k's / v's dtype."""
    b, hq, wq, n, d, hk, wk, dv = _check(q, k, v, dout)
    if dout.shape != (b, hq, wq, n, dv):
        raise ValueError(f"dO {tuple(dout.shape)} does not fit the output {(b, hq, wq, n, dv)}")
    tqh, tqw, urh, urw, idx_h, idx_w, row_lo, col_lo = _plan(
        _lib, "naf_na_bwd_smem", _TILES, (SMEM_MAX,), hq, wq, hk, wk, kernel_size, d, dv,
        str(q.device))
    tiles = -(-hq // tqh) * -(-wq // tqw)
    qc, kc, vc = q.contiguous(), _scaled_keys(k, scale, k.dtype).contiguous(), v.contiguous()
    gc = dout.contiguous()
    dq = torch.empty_like(qc)
    dk = torch.empty((b, hk, wk, n, d), dtype=k.dtype, device=q.device)
    dvv = torch.empty((b, hk, wk, n, dv), dtype=v.dtype, device=q.device)
    partial = torch.empty((b, tiles, n, urh * urw, d + dv), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().naf_na_bwd(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(), idx_h.data_ptr(),
            idx_w.data_ptr(), row_lo.data_ptr(), col_lo.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dvv.data_ptr(), partial.data_ptr(), scale, b, hq, wq, hk, wk, n, d,
            dv, kernel_size, tqh, tqw, urh, urw, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"na2d_fused backward kernel launch failed: cudaError {err}")
    cross_scale_na2d_fused.bwd_launches += 1
    return dq, dk, dvv


class _FusedNA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kernel_size, scale, row_cell0, full_hq):
        ctx.meta = (kernel_size, scale)
        ctx.banded = full_hq != q.shape[1] or row_cell0 != 0
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return cross_scale_na2d_fused_ref(q, k, v, kernel_size, scale, row_cell0, full_hq)
        return _launch_fwd(q, k, v, kernel_size, scale, *_band_rows(q, k, row_cell0, full_hq))

    @staticmethod
    def backward(ctx, g):
        if ctx.banded:
            raise NotImplementedError("banded fused NA is inference-only")
        kernel_size, scale = ctx.meta
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype)
        if q.device.type == "cpu":
            grads = cross_scale_na2d_fused_bwd_ref(q, k, v, g, kernel_size, scale)
        else:
            grads = _launch_bwd(q, k, v, g, kernel_size, scale)
        return (*grads, None, None, None, None)


def cross_scale_na2d_fused(q, k, v, kernel_size: int, scale=None, row_cell0: int = 0,
                           full_hq=None):
    """Cross-scale NA, differentiable. q (B, Hq, Wq, n, d), k (B, hk, wk, n, d),
    v (B, hk, wk, n, dv) -> (B, Hq, Wq, n, dv) in q's dtype; scale defaults to
    d**-0.5. CUDA tensors launch K3 forward and K4 backward; CPU tensors run
    the plain versions.

    Banded execution (inference only; K4 raises, as the JAX package does):
    q holds the query rows from LR cell row ``row_cell0`` on of a
    ``full_hq``-row grid, and the windows follow the global grid."""
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel size must be odd, got {kernel_size}")
    full = q.shape[1] if full_hq is None else int(full_hq)
    _band_rows(q, k, row_cell0, full)
    return _FusedNA.apply(q, k, v, kernel_size, _scale(q, scale), int(row_cell0), full)


cross_scale_na2d_fused.launches = 0
cross_scale_na2d_fused.bwd_launches = 0
