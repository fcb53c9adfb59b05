"""Fused NAF upsampling attention: kernel K2 and its plain version.

Counterpart of ``naf_tpu/kernels/na2d_fused_q.py`` (public entry
``naf_upsample_attention``, kernel ``_fused_q_impl``). One kernel
(``csrc/na2d_fused_q.cu``) computes per output pixel: the adaptive pool-up of
the encoder output, RoPE from the separable row/column cos|sin tables, and
cross-scale neighbourhood attention over the k x k LR-cell window with an f32
softmax. Neither the pooled-up grid nor the queries reach device memory.

The window comes from the host-built tables of ``ops.window`` (natten's rule,
every ratio the oracle takes); for each tile of queries the host also finds
the box of LR cells its windows touch, which the kernel stages in shared
memory. The softmax scale is folded into the keys here, as the JAX wrapper
does.

The wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises. Its backward differentiates a twin, as the
JAX package's ``_fused_q_twin`` does: pool-up and RoPE through torch
autograd, then the attention through ``cross_scale_na2d_fused``, whose
forward and backward are kernels K3 and K4 on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from naf_torch.kernels import _build
from naf_torch.kernels.encoder_fused import _detached, _grads
from naf_torch.kernels.na2d_fused import (
    SMEM_BUDGET, SMEM_MAX, _plan, _scaled_keys, cross_scale_na2d_fused,
)
from naf_torch.nn.rope import rotate_half
from naf_torch.ops.na2d import cross_scale_na2d
from naf_torch.ops.pool import adaptive_avg_pool2d

__all__ = ["naf_upsample_attention", "naf_upsample_attention_ref", "fused_q_twin"]

# Query tiles tried in order, largest first; the first whose K/V box fits
# the shared-memory budget (two blocks per SM) is used.
_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))


def naf_upsample_attention_ref(enc, keys, values, rows_tab, cols_tab, rope_d_head=64, *,
                               num_heads: int, kernel_size: int, scale=None):
    """Plain version of K2.

    enc (B, hi, wi, C) encoder output (before pool-up and RoPE); keys
    (B, hk, wk, C) RoPE'd pooled keys; values (B, hk, wk, Cv);
    rows_tab (Hq, 2C) / cols_tab (Wq, 2C) cos|sin RoPE tables. Pool, RoPE,
    logits and softmax run in f32; returns (B, Hq, Wq, Cv) in enc's dtype.
    """
    b, hi, wi, c = enc.shape
    hq, wq = rows_tab.shape[0], cols_tab.shape[0]
    _, hk, wk, cv = values.shape
    n = num_heads
    d, dv = c // n, cv // n
    if scale is None:
        scale = d ** -0.5
    xu = adaptive_avg_pool2d(enc.float(), (hq, wq))
    rot = rotate_half(xu, rope_d_head)
    rt, ct = rows_tab.float(), cols_tab.float()
    q = xu * (rt[:, None, :c] * ct[None, :, :c]) + rot * (rt[:, None, c:] * ct[None, :, c:])
    k = _scaled_keys(keys, scale, enc.dtype).float()
    out = cross_scale_na2d(
        q.reshape(b, hq, wq, n, d), k.reshape(b, hk, wk, n, d),
        values.float().reshape(b, hk, wk, n, dv), kernel_size, scale=1.0,
    )
    return out.reshape(b, hq, wq, cv).to(enc.dtype)


@functools.cache
def _lib():
    lib = _build.load("na2d_fused_q")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.naf_fused_q_smem.argtypes = [i32] * 5
    lib.naf_fused_q_smem.restype = ctypes.c_longlong
    lib.naf_fused_q.argtypes = [ptr] * 10 + [i32] * 17 + [ptr]
    lib.naf_fused_q.restype = i32
    return lib


def _launch(enc, keys, values, rows_tab, cols_tab, rope_d_head, num_heads, kernel_size,
            scale):
    """Launch K2 on CUDA tensors; returns (B, Hq, Wq, Cv) in enc's dtype."""
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
    tqh, tqw, urh, urw, idx_h, idx_w, row_lo, col_lo = _plan(
        _lib, "naf_fused_q_smem", _TILES, (SMEM_BUDGET, SMEM_MAX), hq, wq, hk, wk, kernel_size,
        d, dv, str(enc.device))
    k_scaled = _scaled_keys(keys, scale, enc.dtype).contiguous()
    rt = rows_tab.float().contiguous()
    ct = cols_tab.float().contiguous()
    out = torch.empty((b, hq, wq, cv), dtype=enc.dtype, device=enc.device)
    with torch.cuda.device(enc.device):
        err = _lib().naf_fused_q(
            enc.data_ptr(), k_scaled.data_ptr(), values.data_ptr(), rt.data_ptr(),
            ct.data_ptr(), idx_h.data_ptr(), idx_w.data_ptr(), row_lo.data_ptr(),
            col_lo.data_ptr(), out.data_ptr(), b, hi, wi, hq, wq, hk, wk, c, n, cv,
            kernel_size, rope_d_head, tqh, tqw, urh, urw, int(enc.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"na2d_fused_q kernel launch failed: cudaError {err}")
    naf_upsample_attention.launches += 1
    return out


def fused_q_twin(enc, keys, values, rows_tab, cols_tab, rope_d_head=64, *,
                 num_heads: int, kernel_size: int, scale=None):
    """Differentiation twin of K2 (JAX ``_fused_q_twin``): pool-up -> RoPE
    from the separable tables -> ``cross_scale_na2d_fused``. q is formed in
    enc's dtype, as in the JAX twin."""
    b, hi, wi, c = enc.shape
    hq, wq = rows_tab.shape[0], cols_tab.shape[0]
    _, hk, wk, cv = values.shape
    n = num_heads
    d, dv = c // n, cv // n
    xu = adaptive_avg_pool2d(enc, (hq, wq))
    rot = rotate_half(xu, rope_d_head)
    cos = (rows_tab[:, None, :c] * cols_tab[None, :, :c]).to(xu.dtype)
    sin = (rows_tab[:, None, c:] * cols_tab[None, :, c:]).to(xu.dtype)
    q = xu * cos + rot * sin
    out = cross_scale_na2d_fused(
        q.reshape(b, hq, wq, n, d), keys.reshape(b, hk, wk, n, d),
        values.reshape(b, hk, wk, n, dv), kernel_size, scale=scale)
    return out.reshape(b, hq, wq, cv)


class _FusedQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, keys, values, rows_tab, cols_tab, rope_d_head, num_heads,
                kernel_size, scale):
        ctx.meta = (rope_d_head, num_heads, kernel_size, scale)
        ctx.save_for_backward(enc, keys, values, rows_tab, cols_tab)
        return _launch(enc, keys, values, rows_tab, cols_tab, rope_d_head, num_heads,
                       kernel_size, scale)

    @staticmethod
    def backward(ctx, g):
        rope_d_head, num_heads, kernel_size, scale = ctx.meta
        inputs = _detached(ctx.saved_tensors, ctx)
        with torch.enable_grad():
            out = fused_q_twin(*inputs, rope_d_head, num_heads=num_heads,
                               kernel_size=kernel_size, scale=scale)
        return (*_grads((out,), (g,), inputs), None, None, None, None)


def naf_upsample_attention(enc, keys, values, rows_tab, cols_tab, rope_d_head=64, *,
                           num_heads: int, kernel_size: int, scale=None):
    """Fused pool-up + RoPE + cross-scale NA (arguments as in the plain
    version). CPU tensors take the plain version; CUDA tensors launch K2
    (count in ``naf_upsample_attention.launches``)."""
    if enc.device.type == "cpu":
        return naf_upsample_attention_ref(
            enc, keys, values, rows_tab, cols_tab, rope_d_head, num_heads=num_heads,
            kernel_size=kernel_size, scale=scale)
    return _FusedQ.apply(enc, keys, values, rows_tab, cols_tab, rope_d_head, num_heads,
                         kernel_size, scale)


naf_upsample_attention.launches = 0
