"""Fused NAF upsampling attention: kernel K2 and its plain version.

Counterpart of ``naf_tpu/kernels/na2d_fused_q.py`` (public entry
``naf_upsample_attention``, kernel ``_fused_q_impl``). One kernel
(``csrc/na2d_fused_q.cu``) computes per output pixel: the adaptive pool-up of
the encoder output, RoPE from the separable row/column cos|sin tables, and
cross-scale neighbourhood attention over the k x k LR-cell window with an f32
softmax. Neither the pooled-up grid nor the queries reach device memory.

``csrc/na2d_fused_q.cu`` holds two kernels, chosen from the dtype alone as
K3's are (``na2d_fused._route``): bf16 on the tensor cores ("wgmma": K3's
forward tile of ``csrc/na_tc.cuh`` behind a prologue that builds the query
tile on chip), f32 on the CUDA cores ("fma"). The window comes from the
host-built tables of ``ops.window`` (natten's rule, every ratio the oracle
takes); for each tile of queries the host also finds the box of LR cells
its windows touch, which the kernels stage in shared memory: the bf16 route
plans as K3 does (``na2d_fused._plan_tc``: 64-query tiles, per-axis window
counts, boxes above 192 cells in chunks) with the keys' and values' head
channels zero-padded to a multiple of 16, the softmax scale passed to the
kernel, which stores only the real value channels, and the tiles whose
queries share one window ordered first (:func:`_plan_k2`); the f32 route
shrinks its tile until the box fits (``na2d_fused._plan_fma``), and where no
tile's whole box fits (one head of d 256 at k 15) walks the box in chunks
("fma_chunked": a statistics pass, then exact P per chunk); it takes keys
with the scale folded in, as the JAX wrapper does.

Banded variants (the JAX kernel's ``row_cell0`` / ``band_cells`` /
``out_acc`` / ``enc_banded``) compute only LR cell rows
[row_cell0, row_cell0 + band_cells) of the output with the global window
rule, optionally into a shared full-size output in place and from an
encoder output that holds only the band's input rows: the streamed
4096^2 path (``naf_torch.api.naf_streamed``) and the spatially sharded
forward and train step (``naf_torch.parallel``). A slab is differentiable
(the JAX package's banded calls are not); ``out_acc`` writes in place and
is inference-only.

The wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises (launches counted in
``naf_upsample_attention.launches``, per route in
``naf_upsample_attention.route_launches``). Its backward differentiates a
twin, as the JAX package's ``_fused_q_twin`` does: pool-up and RoPE through
torch autograd, then the attention through ``cross_scale_na2d_fused``, whose
forward and backward are kernels K3 and K4 on CUDA tensors; a band's twin
pools the band's rows and attends with K3/K4's banded calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from naf_torch.kernels import _build, na2d_fused
from naf_torch.kernels.encoder_fused import _detached, _grads
from naf_torch.kernels.na2d_fused import (
    PAD, SMEM_BUDGET, SMEM_MAX, TC_NB, _aligned, _pad_heads, _plan_fma, _plan_tc, _route,
    _scaled_keys, cross_scale_na2d_fused,
)
from naf_torch.nn.rope import rotate_half
from naf_torch.ops.na2d import cross_scale_na2d
from naf_torch.ops.pool import _pool_matrix, adaptive_avg_pool2d
from naf_torch.utils.spans import span, to_device

__all__ = ["naf_upsample_attention", "naf_upsample_attention_ref", "fused_q_twin"]

# Query tiles of the f32 route, tried in order, largest first; the first
# whose K/V box fits the shared-memory budget (two blocks per SM) is used.
_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))


def _band(enc_shape, hq: int, hk: int, row_cell0: int, band_cells, enc_banded: bool):
    """(y0, band_h, hi_full, enc_row0) of a call: its first global query
    row and number of rows, the input rows of the whole encoder grid, and
    the first of them that enc holds. The full-grid call is (0, Hq, hi, 0).
    Validated as the JAX kernel's banded calls are, without its cell-block
    multiple: whole cell rows, and with ``enc_banded`` an encoder band of
    whole input rows that holds exactly the band's pooled rows."""
    hi = enc_shape[1]
    if row_cell0 == 0 and band_cells is None and not enc_banded:
        return 0, hq, hi, 0
    if enc_banded and band_cells is None:
        raise ValueError("enc_banded requires band_cells")
    if hk <= 0 or hq % hk:
        raise ValueError(f"a banded call needs whole cell rows: Hq {hq} % hk {hk} != 0")
    if band_cells is None:
        band_cells = hk - row_cell0
    if row_cell0 < 0 or band_cells <= 0 or row_cell0 + band_cells > hk:
        raise ValueError(f"cell rows [{row_cell0}, {row_cell0 + band_cells}) outside [0, {hk})")
    r_h = hq // hk
    y0, band_h = row_cell0 * r_h, band_cells * r_h
    if not enc_banded:
        return y0, band_h, hi, 0
    if (hi * hq) % band_h:
        raise ValueError(f"banded enc rows {hi} do not divide evenly into the band's {band_h} "
                         f"output rows at ratio {hq}/{hi}")
    hi_full = hi * hq // band_h
    if (y0 * hi_full) % hq:
        raise ValueError(f"the band's first output row {y0} maps to no whole encoder row "
                         f"({hi_full} rows for {hq})")
    return y0, band_h, hi_full, y0 * hi_full // hq


def _check_out_acc(out_acc, enc, b, hq, wq, cv):
    if (out_acc.shape != (b, hq, wq, cv) or out_acc.dtype != enc.dtype
            or out_acc.device != enc.device or not out_acc.is_contiguous()):
        raise ValueError(f"out_acc must be a contiguous {(b, hq, wq, cv)} {enc.dtype} tensor "
                         f"on {enc.device}")


def _pool_band(x, hq: int, wq: int, y0: int, band_h: int, hi_full: int, enc_row0: int):
    """Adaptive pool of x to query rows [y0, y0 + band_h) of an (hq, wq)
    grid, x holding input rows from enc_row0 on of an hi_full-row grid."""
    if (y0, band_h, hi_full) == (0, hq, x.shape[1]):
        return adaptive_avg_pool2d(x, (hq, wq))
    ph = _pool_matrix(hi_full, hq)[y0 : y0 + band_h, enc_row0 : enc_row0 + x.shape[1]]
    x = torch.einsum("oh,bhwc->bowc", to_device(ph, x.device, x.dtype), x)
    return adaptive_avg_pool2d(x, (band_h, wq))


def naf_upsample_attention_ref(enc, keys, values, rows_tab, cols_tab, rope_d_head=64, *,
                               num_heads: int, kernel_size: int, scale=None,
                               row_cell0: int = 0, band_cells=None, out_acc=None,
                               enc_banded: bool = False):
    """Plain version of K2.

    enc (B, hi, wi, C) encoder output (before pool-up and RoPE); keys
    (B, hk, wk, C) RoPE'd pooled keys; values (B, hk, wk, Cv);
    rows_tab (Hq, 2C) / cols_tab (Wq, 2C) cos|sin RoPE tables. Pool, RoPE,
    logits and softmax run in f32; returns (B, Hq, Wq, Cv) in enc's dtype.

    Banded: ``row_cell0``/``band_cells`` compute only LR cell rows
    [row_cell0, row_cell0 + band_cells) (global windows) and return that
    (B, band_cells * Hq/hk, Wq, Cv) slab, or, with ``out_acc`` (B, Hq, Wq, Cv),
    write those rows into it in place and return it (every other row is
    left as it was). ``enc_banded``: enc holds only the band's input rows.
    """
    b, hi, wi, c = enc.shape
    hq, wq = rows_tab.shape[0], cols_tab.shape[0]
    _, hk, wk, cv = values.shape
    y0, band_h, hi_full, enc_row0 = _band(enc.shape, hq, hk, row_cell0, band_cells, enc_banded)
    if out_acc is not None:
        _check_out_acc(out_acc, enc, b, hq, wq, cv)
    n = num_heads
    d, dv = c // n, cv // n
    if scale is None:
        scale = d ** -0.5
    xu = _pool_band(enc.float(), hq, wq, y0, band_h, hi_full, enc_row0)
    rot = rotate_half(xu, rope_d_head)
    rt, ct = rows_tab.float()[y0 : y0 + band_h], cols_tab.float()
    q = xu * (rt[:, None, :c] * ct[None, :, :c]) + rot * (rt[:, None, c:] * ct[None, :, c:])
    k = _scaled_keys(keys, scale, enc.dtype).float()
    out = cross_scale_na2d(
        q.reshape(b, band_h, wq, n, d), k.reshape(b, hk, wk, n, d),
        values.float().reshape(b, hk, wk, n, dv), kernel_size, scale=1.0, row0=y0, full_hq=hq,
    ).reshape(b, band_h, wq, cv).to(enc.dtype)
    if out_acc is None:
        return out
    out_acc[:, y0 : y0 + band_h] = out
    return out_acc


@functools.cache
def _lib():
    lib = _build.load("na2d_fused_q")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.naf_fused_q_smem.argtypes = lib.naf_fused_q_chunk_smem.argtypes = [i32] * 5
    lib.naf_fused_q_tc_smem.argtypes = [i32] * 3
    for fn in (lib.naf_fused_q_smem, lib.naf_fused_q_chunk_smem, lib.naf_fused_q_tc_smem):
        fn.restype = ctypes.c_longlong
    lib.naf_fused_q_fma.argtypes = [ptr] * 10 + [i32] * 22 + [ptr]
    lib.naf_fused_q_fma_chunked.argtypes = [ptr] * 10 + [i32] * 24 + [ptr]
    lib.naf_fused_q_wgmma.argtypes = [ptr] * 11 + [ctypes.c_float] + [i32] * 25 + [ptr]
    for fn in (lib.naf_fused_q_fma, lib.naf_fused_q_fma_chunked, lib.naf_fused_q_wgmma):
        fn.restype = i32
    return lib


def _tc_smem(d: int, dv: int, nb: int) -> int:
    """Shared memory of one block of the bf16 K2 (``tc_smem`` in the
    kernel's source): K3's forward block (``na2d_fused._tc_smem``), and up
    to 192 cells a row of nb f32 window biases."""
    return na2d_fused._tc_smem(d, dv, nb, False) + (4 * nb if nb <= TC_NB[-1] else 0)


def _uniform_tiles(cnt, tile: int):
    """bool per tile along one axis: True where the tile's queries all lie
    inside the grid and share one row of the count table ``cnt`` (one window
    on that axis); at a ratio of 8 or more most 8-query tiles do."""
    full = cnt.shape[0] // tile
    flags = torch.zeros(-(-cnt.shape[0] // tile), dtype=torch.bool, device=cnt.device)
    if full:
        rows = cnt[: full * tile].reshape(full, tile, -1)
        flags[:full] = (rows == rows[:, :1]).all(2).all(1)
    return flags


@functools.lru_cache(maxsize=64)
def _plan_k2(hq, wq, hk, wk, ks, dp, dvp, device, rows=None):
    """The bf16 route's plan (``na2d_fused._plan_tc``, the rows of a band),
    then the order the kernel's blocks take its tiles in (int32) and how
    many come first as uniform: uniform on both axes, their queries share
    one window, which the kernel takes as one row of biases; each group in
    tile order. Raises where the block's shared memory, biases included,
    exceeds SMEM_MAX."""
    plan = _plan_tc(hq, wq, hk, wk, ks, dp, dvp, False, device, rows)
    if _tc_smem(dp, dvp, plan[4]) > SMEM_MAX:
        raise ValueError(f"K2's tensor-core block needs {_tc_smem(dp, dvp, plan[4])} bytes of "
                         f"shared memory at d={dp}, dv={dvp}, a box of {plan[4]} cells")
    uniform = (_uniform_tiles(plan[5], plan[0])[:, None]
               & _uniform_tiles(plan[6], plan[1])[None, :]).flatten()
    order = torch.argsort((~uniform).to(torch.int32), stable=True).to(torch.int32)
    return (*plan, order, int(uniform.sum()))


def _launch(enc, keys, values, rows_tab, cols_tab, rope_d_head, num_heads, kernel_size,
            scale, row_cell0=0, band_cells=None, out_acc=None, enc_banded=False):
    """Launch K2 on CUDA tensors; returns (B, Hq, Wq, Cv) in enc's dtype, or
    a banded call's slab or ``out_acc`` (see the plain version)."""
    tensors = (enc, keys, values, rows_tab, cols_tab)
    if any(t.device.type != "cuda" or t.device != enc.device for t in tensors):
        raise ValueError("K2 launches on CUDA tensors, all on one device")
    if enc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 takes float32 or bfloat16, got {enc.dtype}")
    if keys.dtype != enc.dtype or values.dtype != enc.dtype:
        raise TypeError("enc, keys and values must share one dtype")
    if not all(t.is_contiguous() for t in (enc, keys, values)):
        raise ValueError("K2 takes contiguous NHWC tensors")
    b, hi, wi, c = enc.shape
    _, hk, wk, cv = values.shape
    hq, wq = rows_tab.shape[0], cols_tab.shape[0]
    n = num_heads
    if keys.shape != (b, hk, wk, c) or values.shape[0] != b:
        raise ValueError(f"keys {tuple(keys.shape)} / values {tuple(values.shape)} do not "
                         f"fit enc {tuple(enc.shape)}")
    if rows_tab.shape != (hq, 2 * c) or cols_tab.shape != (wq, 2 * c):
        raise ValueError("RoPE tables must be (Hq, 2C) and (Wq, 2C)")
    if c % n or (c // n) % 4 or cv % n:
        raise ValueError("K2 needs C % heads == 0, (C/heads) % 4 == 0, Cv % heads == 0")
    if rope_d_head % 2 or c % rope_d_head:
        raise ValueError(f"rope_d_head {rope_d_head} must be even and divide C={c}")
    d, dv = c // n, cv // n
    if scale is None:
        scale = d ** -0.5
    y0, band_h, hi_full, enc_row0 = _band(enc.shape, hq, hk, row_cell0, band_cells, enc_banded)
    rows = None if band_h == hq else (y0, y0 + band_h)
    route = _route(enc.dtype)
    rt, ct = _aligned(rows_tab.float()), _aligned(cols_tab.float())
    if out_acc is not None:
        _check_out_acc(out_acc, enc, b, hq, wq, cv)
        out, out_row0 = out_acc, 0
    else:
        out = torch.empty((b, band_h, wq, cv), dtype=enc.dtype, device=enc.device)
        out_row0 = y0
    band = (b, hi, wi, hi_full, enc_row0, hq, wq, y0, band_h, out.shape[1], out_row0, hk, wk)
    dev = str(enc.device)
    with torch.cuda.device(enc.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            # head channels of keys and values zero-padded; enc read as it lies
            encp = _aligned(enc)
            kp = _aligned(_pad_heads(keys.reshape(b, hk, wk, n, d), PAD[route]))
            vp = _aligned(_pad_heads(values.reshape(b, hk, wk, n, dv), PAD[route]))
            dp, dvp = kp.shape[-1], vp.shape[-1]
            tqh, tqw, urh, urw, nb, *tables, n_uniform = _plan_k2(
                hq, wq, hk, wk, kernel_size, dp, dvp, dev, rows)
            err = _lib().naf_fused_q_wgmma(
                encp.data_ptr(), kp.data_ptr(), vp.data_ptr(), rt.data_ptr(), ct.data_ptr(),
                *(t.data_ptr() for t in tables), out.data_ptr(), scale, *band, c, n, dp, dvp,
                dv, rope_d_head, tqh, tqw, urh, urw, nb, n_uniform, stream)
        else:
            route, plan = _plan_fma(_lib, "naf_fused_q_smem", "naf_fused_q_chunk_smem", _TILES,
                                    (SMEM_BUDGET, SMEM_MAX), hq, wq, hk, wk, kernel_size, d, dv,
                                    dev, rows)
            tqh, tqw, urh, urw, idx_h, idx_w, row_lo, col_lo, *chunk = plan
            k_scaled = _scaled_keys(keys, scale, enc.dtype).contiguous()
            fn = _lib().naf_fused_q_fma if route == "fma" else _lib().naf_fused_q_fma_chunked
            err = fn(enc.data_ptr(), k_scaled.data_ptr(), values.data_ptr(), rt.data_ptr(),
                     ct.data_ptr(), idx_h.data_ptr(), idx_w.data_ptr(), row_lo.data_ptr(),
                     col_lo.data_ptr(), out.data_ptr(), *band, c, n, cv, kernel_size,
                     rope_d_head, tqh, tqw, urh, urw, *chunk, stream)
    if err:
        raise RuntimeError(f"na2d_fused_q kernel ({route}) launch failed: cudaError {err}")
    naf_upsample_attention.launches += 1
    naf_upsample_attention.route_launches[route] += 1
    return out


def fused_q_twin(enc, keys, values, rows_tab, cols_tab, rope_d_head=64, *,
                 num_heads: int, kernel_size: int, scale=None, row_cell0: int = 0,
                 band_cells=None, enc_banded: bool = False):
    """Differentiation twin of K2 (JAX ``_fused_q_twin``): pool-up -> RoPE
    from the separable tables -> ``cross_scale_na2d_fused``. q is formed in
    enc's dtype, as in the JAX twin. A band (``row_cell0``, ``band_cells``,
    ``enc_banded`` as in the plain version) pools only its query rows
    (:func:`_pool_band`), takes its rows of the RoPE row table and attends
    with K3/K4's banded call; it returns the band's slab."""
    b, hi, wi, c = enc.shape
    hq, wq = rows_tab.shape[0], cols_tab.shape[0]
    _, hk, wk, cv = values.shape
    n = num_heads
    d, dv = c // n, cv // n
    y0, band_h, hi_full, enc_row0 = _band(enc.shape, hq, hk, row_cell0, band_cells, enc_banded)
    xu = _pool_band(enc, hq, wq, y0, band_h, hi_full, enc_row0)
    rot = rotate_half(xu, rope_d_head)
    rt = rows_tab[y0 : y0 + band_h]
    cos = (rt[:, None, :c] * cols_tab[None, :, :c]).to(xu.dtype)
    sin = (rt[:, None, c:] * cols_tab[None, :, c:]).to(xu.dtype)
    q = xu * cos + rot * sin
    out = cross_scale_na2d_fused(
        q.reshape(b, band_h, wq, n, d), keys.reshape(b, hk, wk, n, d),
        values.reshape(b, hk, wk, n, dv), kernel_size, scale=scale,
        row_cell0=row_cell0, full_hq=hq)
    return out.reshape(b, band_h, wq, cv)


class _FusedQ(torch.autograd.Function):
    """K2 forward (a whole grid or a band's slab), the twin's gradient."""

    @staticmethod
    def forward(ctx, enc, keys, values, rows_tab, cols_tab, rope_d_head, num_heads,
                kernel_size, scale, row_cell0, band_cells, enc_banded):
        ctx.meta = (rope_d_head, num_heads, kernel_size, scale)
        ctx.band = dict(row_cell0=row_cell0, band_cells=band_cells, enc_banded=enc_banded)
        ctx.save_for_backward(enc, keys, values, rows_tab, cols_tab)
        return _launch(enc, keys, values, rows_tab, cols_tab, rope_d_head, num_heads,
                       kernel_size, scale, **ctx.band)

    @staticmethod
    def backward(ctx, g):
        rope_d_head, num_heads, kernel_size, scale = ctx.meta
        with span("naf.attention.backward"):
            inputs = _detached(ctx.saved_tensors, ctx)
            with torch.enable_grad():
                out = fused_q_twin(*inputs, rope_d_head, num_heads=num_heads,
                                   kernel_size=kernel_size, scale=scale, **ctx.band)
            return (*_grads((out,), (g,), inputs), *[None] * 7)


def naf_upsample_attention(enc, keys, values, rows_tab, cols_tab, rope_d_head=64, *,
                           num_heads: int, kernel_size: int, scale=None, row_cell0: int = 0,
                           band_cells=None, out_acc=None, enc_banded: bool = False):
    """Fused pool-up + RoPE + cross-scale NA (arguments as in the plain
    version). CPU tensors take the plain version; CUDA tensors launch K2
    (count in ``naf_upsample_attention.launches``, per route in
    ``naf_upsample_attention.route_launches``: bf16 "wgmma", f32 "fma", or
    "fma_chunked" where no tile's whole K/V box fits shared memory).

    The full-grid call and a band's slab (``row_cell0``, ``band_cells``,
    ``enc_banded``) are differentiable through :func:`fused_q_twin`: the
    gradient reaches the band's ``enc`` rows, the whole ``keys`` and
    ``values``. On CPU tensors a band under autograd runs the twin itself
    (the plain K3/K4), so that its arithmetic is the one the card's
    backward differentiates. ``out_acc`` writes in place and raises if a
    gradient is required."""
    tensors = (enc, keys, values, rows_tab, cols_tab)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    band = dict(row_cell0=row_cell0, band_cells=band_cells, enc_banded=enc_banded)
    if out_acc is not None:
        if needs_grad:
            raise NotImplementedError("out_acc writes in place: K2 into out_acc is "
                                      "inference-only")
        if enc.device.type == "cpu":
            return naf_upsample_attention_ref(*tensors, rope_d_head, num_heads=num_heads,
                                              kernel_size=kernel_size, scale=scale,
                                              out_acc=out_acc, **band)
        return _launch(*tensors, rope_d_head, num_heads, kernel_size, scale, out_acc=out_acc,
                       **band)
    if enc.device.type == "cpu":
        banded = row_cell0 != 0 or band_cells is not None or enc_banded
        fn = fused_q_twin if banded and needs_grad else naf_upsample_attention_ref
        return fn(*tensors, rope_d_head, num_heads=num_heads, kernel_size=kernel_size,
                  scale=scale, **band)
    return _FusedQ.apply(*tensors, rope_d_head, num_heads, kernel_size, scale, row_cell0,
                         band_cells, enc_banded)


naf_upsample_attention.launches = 0
naf_upsample_attention.route_launches = {"wgmma": 0, "fma": 0, "fma_chunked": 0}
