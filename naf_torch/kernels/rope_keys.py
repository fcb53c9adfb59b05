"""The NAF keys and RoPE tables in one launch (the keys kernel) and its plain version.

What ``NAF._fused_q_inputs`` hands kernel K2 besides the encoder output:

    keys     (B, hk, wk, C) = adaptive_pool(rope(adaptive_pool(enc, up_hw)), down_hw)
    rows_tab (oh, 2C) f32   = cat([cos_r, sin_r], -1) of ``RoPE.tables(oh, ow)``
    cols_tab (ow, 2C) f32   = cat([cos_c, sin_c], -1)      (``RoPE.k2_tables``)

``csrc/rope_keys.cu`` computes all three in one launch: it reads enc once
and writes nothing at full resolution, factoring each RoPE channel into a
row weight times a column weight (every channel's angle depends on one
axis), and takes its pool windows, coordinates and angles from index
arithmetic and the ``periods`` buffer, so that no host array is copied to
the card. It replaces no TPU kernel: the JAX package computes these as
plain jnp. The keys are summed in f32 and rounded once to enc's dtype.

:func:`rope_keys` launches it for CUDA tensors that need no gradient
(count in ``rope_keys.launches``); it takes the plain version
:func:`rope_keys_ref`, which is ``RoPE.pooled`` and ``RoPE.k2_tables``, for
CPU tensors and for inputs under autograd. A band's additive contribution
to the keys (``RoPE.pooled``'s ``row0``/``full_h``: the streamed and
sharded paths) still calls ``RoPE.pooled`` itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from naf_torch.kernels import _build
from naf_torch.kernels.na2d_fused import _aligned

__all__ = ["rope_keys", "rope_keys_ref"]

CH = 32  # most enc rows (columns) of a window weighted per chunk: the kernel's CH
MAX_THREADS = 256  # threads a block
MIN_BLOCKS = 2048  # blocks a grid keeps as its threads take more rows: 8 waves of 2 an SM


def rope_keys_ref(rope, enc: torch.Tensor, up_hw, down_hw):
    """Plain version: ``(keys, rows_tab, cols_tab)`` by ``rope.pooled(enc,
    up_hw, down_hw)`` and ``rope.k2_tables(*up_hw)``."""
    keys = rope.pooled(enc, up_hw, down_hw).contiguous()
    return keys, *rope.k2_tables(int(up_hw[0]), int(up_hw[1]))


def _lo(o: int, n: int, m: int) -> int:
    return o * n // m


def _hi(o: int, n: int, m: int) -> int:
    return -(-(o + 1) * n // m)


def _span(k: int, n_in: int, n_mid: int, n_out: int) -> int:
    """enc positions (of n_in) that key k's window (n_in -> n_mid -> n_out) reads."""
    y0, y1 = _lo(k, n_mid, n_out), _hi(k, n_mid, n_out)
    return _hi(y1 - 1, n_in, n_mid) - _lo(y0, n_in, n_mid)


@functools.lru_cache(maxsize=64)
def _plan(b: int, hi: int, wi: int, oh: int, ow: int, hk: int, wk: int, c: int, dh: int):
    """(v, gb, r, kx, rch, cch, smem) of a launch: channels a thread run (the
    widest of 8, 4, 2 dividing dh / 2), channel groups, row splits and key
    columns a block, rows and columns weighted per chunk, and the dynamic
    shared memory in bytes. A block takes up to 256 threads: every group of
    a pixel, as many row splits as the widest window has rows, then key
    columns. Then, while the grid keeps MIN_BLOCKS blocks, it halves the
    row splits and doubles the key columns: each thread then spends the
    block's weights on more pixels."""
    half = dh // 2
    v = next(n for n in (8, 4, 2) if half % n == 0)
    groups = c // (2 * v)
    gb = min(groups, MAX_THREADS)
    rch = min(CH, max(_span(k, hi, oh, hk) for k in range(hk)))
    cch = min(CH, max(_span(k, wi, ow, wk) for k in range(wk)))
    r = max(1, min(rch, MAX_THREADS // gb))
    kx = max(1, min(wk, MAX_THREADS // (gb * r)))

    def blocks(kx):
        return b * hk * -(-wk // kx) * -(-groups // gb)

    while (r > 1 and 2 * kx <= wk and gb * -(-r // 2) * 2 * kx <= MAX_THREADS
           and blocks(2 * kx) >= MIN_BLOCKS):
        r, kx = -(-r // 2), 2 * kx
    smem = max(8 * (rch + kx * cch) * half, 4 * gb * r * kx * 2 * v)
    return v, gb, r, kx, rch, cch, smem


@functools.cache
def _lib():
    lib = _build.load("rope_keys")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.naf_rope_keys.argtypes = [ptr] * 5 + [i32] * 17 + [ptr]
    lib.naf_rope_keys.restype = i32
    return lib


def _launch(rope, enc: torch.Tensor, up_hw, down_hw):
    """Launch the keys kernel; returns (keys, rows_tab, cols_tab)."""
    if enc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the keys kernel takes float32 or bfloat16, got {enc.dtype}")
    periods = rope.periods
    if periods.device != enc.device or periods.dtype != torch.float32:
        raise ValueError("the RoPE periods must be f32 on enc's device")
    b, hi, wi, c = enc.shape
    dh = rope.d_head
    if c != rope.embed_dim:
        raise ValueError(f"expected {rope.embed_dim} channels, got {c}")
    (oh, ow), (hk, wk) = (int(n) for n in up_hw), (int(n) for n in down_hw)
    if (min(oh, ow, hk, wk) <= 0 or hk > 65535 or b > 65535 or 2 * c * (oh + ow) >= 2**31
            or (max(hi, wi, oh, ow, hk, wk) + 1) ** 2 >= 2**31):
        raise ValueError(f"sizes {tuple(enc.shape)} -> {up_hw} -> {down_hw} are outside the "
                         "keys kernel's 32-bit window arithmetic and grid")
    v, gb, r, kx, rch, cch, smem = _plan(b, hi, wi, oh, ow, hk, wk, c, dh)
    enc = _aligned(enc)
    keys = torch.empty((b, hk, wk, c), dtype=enc.dtype, device=enc.device)
    rows_tab = torch.empty((oh, 2 * c), dtype=torch.float32, device=enc.device)
    cols_tab = torch.empty((ow, 2 * c), dtype=torch.float32, device=enc.device)
    with torch.cuda.device(enc.device):
        err = _lib().naf_rope_keys(
            enc.data_ptr(), periods.data_ptr(), keys.data_ptr(), rows_tab.data_ptr(),
            cols_tab.data_ptr(), b, hi, wi, oh, ow, hk, wk, c, dh, v, gb, r, kx, rch, cch, smem,
            int(enc.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rope_keys kernel launch failed: cudaError {err}")
    rope_keys.launches += 1
    return keys, rows_tab, cols_tab


def rope_keys(rope, enc: torch.Tensor, up_hw, down_hw):
    """``(keys, rows_tab, cols_tab)`` of ``rope`` (a ``naf_torch.nn.rope.RoPE``)
    for the encoder output ``enc`` (B, hi, wi, C): the keys pooled onto
    ``up_hw``, RoPE'd and pooled onto ``down_hw``, in enc's dtype, and the
    f32 cos|sin tables of the ``up_hw`` grid. CUDA tensors that need no
    gradient launch the keys kernel; everything else takes
    :func:`rope_keys_ref`."""
    needs_grad = torch.is_grad_enabled() and (enc.requires_grad or rope.periods.requires_grad)
    if enc.device.type != "cuda" or needs_grad:
        return rope_keys_ref(rope, enc, up_hw, down_hw)
    return _launch(rope, enc, up_hw, down_hw)


rope_keys.launches = 0
