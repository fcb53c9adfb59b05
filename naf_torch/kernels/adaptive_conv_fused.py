"""Spatially varying convolution: kernel K5 and its plain version.

Counterpart of ``naf_tpu/kernels/adaptive_conv_fused.py``. FeatUp's
AdaptiveConv applies a per-pixel k x k kernel to an already padded source:

    out[b, y, x, :] = sum_{i,j} kernel[b, y, x, i, j] * source_padded[b, y+i, x+j, :]

with source_padded (B, H+k-1, W+k-1, C) and kernel (B, H, W, k, k). The
weights and the accumulation are f32; the output is in
``promote(source, kernel)``, as in the JAX package.

``csrc/adaptive_conv.cu`` reads the source and the weights once and writes
the output once, by one of two routes that :func:`_plan_k5` picks from the
shape: "narrow" (C <= 8, JBU: the bytes are the weights, streamed by
cp.async, one thread per output pixel) and "wide" (C > 8, FeatUp: tiles of
TH x 16 pixels, a grid axis over channel chunks, 32-channel stages through a
two-buffer cp.async ring, 4 pixels x 8 channels per thread). Both take any
B <= 65535, H, W, C and every odd k up to 15, in f32 or bf16; the plan raises
where no tile fits a block's shared memory. :func:`adaptive_conv_fused`
launches on CUDA tensors (count in ``adaptive_conv_fused.launches``, per
route in ``adaptive_conv_fused.route_launches``) and takes the plain version
:func:`adaptive_conv_fused_ref` for CPU tensors only. The gradient is
``naf_torch.ops.adaptive_conv.adaptive_conv``'s.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from naf_torch.kernels import _build

__all__ = ["adaptive_conv_fused", "adaptive_conv_fused_ref", "MAX_K"]

MAX_K = 15  # csrc/adaptive_conv.cu's naf_adaptive_conv_max_k()
# The card (H100): SMs, shared memory a block may use and an SM holds, the
# shared memory the runtime keeps per block, threads per SM.
SMS = 132
SMEM_LIMIT = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
THREADS_SM = 2048
NARROW_MAX_C = 8  # channels up to which the narrow route runs
# narrow: threads (= pixels of one output row) per block, tried in order
NARROW_TILES = (128, 64, 32)
# wide: tile rows (tile columns WIDE_TW, one thread per 4 pixels x 8
# channels of a stage of WIDE_STAGE channels, WIDE_DEPTH ring buffers: the
# kernel's compile-time WDEPTH)
WIDE_TH = (8, 4)
WIDE_TW = 16
WIDE_STAGE = 32
WIDE_DEPTH = 2
# waves of blocks the wide route's channel chunks aim for
WIDE_WAVES = 2


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """One launch of K5, as ``csrc/adaptive_conv.cu`` sizes it.

    tile: output pixels of a block (rows, columns), as many as its threads;
    stages: 32-channel stages a block walks, its channel
    chunk (narrow 1: all C channels); smem: dynamic shared memory of a block
    in bytes; grid: (x, y, z) blocks, x the tiles, y the channel chunks, z
    the samples."""

    route: str
    tile: tuple[int, int]
    stages: int
    smem: int
    grid: tuple[int, int, int]


def _blocks_per_sm(threads: int, smem: int) -> int:
    return min(THREADS_SM // threads, 32, SMEM_SM // (smem + SMEM_RESERVED))


def narrow_smem(k: int, tw: int, c: int) -> int:
    """Bytes: the row segment's weights (+ 8 floats of alignment slack) and
    its K x (tw + k - 1) halo, channels zero-padded to 4 or 8 f32."""
    return 4 * (tw * k * k + 8) + 16 * math.ceil(c / 4) * k * (tw + k - 1)


def wide_smem(k: int, th: int, itemsize: int) -> int:
    """Bytes: the tile's weights tap-major, [k*k][th*16 + 4] f32, and a ring
    of WIDE_DEPTH halos of (th+k-1) x (16+k-1) pixels of 32 channels plus 16
    bytes of padding each, in the source's dtype."""
    halo_px = (th + k - 1) * (WIDE_TW + k - 1)
    return 4 * k * k * (th * WIDE_TW + 4) + WIDE_DEPTH * halo_px * (
        WIDE_STAGE * itemsize + 16)


@functools.lru_cache(maxsize=256)
def _plan_k5(b, h, w, c, k, dtype) -> K5Plan:
    """Route, tile, channel chunk, shared memory and grid of one K5 launch
    (the wide route's ring is WIDE_DEPTH deep at every shape). Among the
    tiles that fit a block's shared memory, the one with the most warps per
    SM, then the most blocks per SM (a block's stages wait at a barrier;
    another block fills the SM meanwhile), then the largest; raises where
    none fits."""
    itemsize = dtype.itemsize
    best = None
    if c <= NARROW_MAX_C:
        for tw in NARROW_TILES:
            smem = narrow_smem(k, tw, c)
            if smem <= SMEM_LIMIT:
                bps = _blocks_per_sm(tw, smem)
                key = (bps * tw // 32, bps, tw)
                if best is None or key > best[0]:
                    best = (key, K5Plan("narrow", (1, tw), 1, smem,
                                        (h * math.ceil(w / tw), 1, b)))
    else:
        nst = math.ceil(c / WIDE_STAGE)
        for th in WIDE_TH:
            smem = wide_smem(k, th, itemsize)
            if smem > SMEM_LIMIT:
                continue
            threads = th * WIDE_TW
            bps = _blocks_per_sm(threads, smem)
            tiles = math.ceil(h / th) * math.ceil(w / WIDE_TW)
            # the fewest chunks that give WIDE_WAVES waves of blocks
            chunks = min(nst, max(1, math.ceil(WIDE_WAVES * SMS * bps / (tiles * b))))
            spc = math.ceil(nst / chunks)
            chunks = math.ceil(nst / spc)
            key = (bps * threads // 32, bps, threads)
            if best is None or key > best[0]:
                best = (key, K5Plan("wide", (th, WIDE_TW), spc, smem, (tiles, chunks, b)))
    if best is None:
        raise ValueError(f"K5: no tile of the {'narrow' if c <= NARROW_MAX_C else 'wide'} "
                         f"route fits {SMEM_LIMIT} bytes of shared memory at C {c}, k {k}")
    return best[1]


def _shapes(source_padded, kernel):
    if source_padded.ndim != 4 or kernel.ndim != 5:
        raise ValueError("adaptive conv takes source (B, H+k-1, W+k-1, C) and "
                         "kernel (B, H, W, k, k)")
    b, hp, wp, c = source_padded.shape
    kh, kw = kernel.shape[3], kernel.shape[4]
    h, w = hp - kh + 1, wp - kw + 1
    if kernel.shape[:3] != (b, h, w):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit source "
                         f"{tuple(source_padded.shape)}")
    return b, h, w, c, kh, kw


def adaptive_conv_fused_ref(source_padded, kernel):
    """Plain version of K5: one multiply-add pass per tap, f32 weights and
    accumulation, ``promote(source, kernel)`` out."""
    b, h, w, c, kh, kw = _shapes(source_padded, kernel)
    dtype = torch.promote_types(source_padded.dtype, kernel.dtype)
    src = source_padded.to(dtype)
    wgt = kernel.float()
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=source_padded.device)
    for i in range(kh):
        for j in range(kw):
            acc += src[:, i : i + h, j : j + w, :].float() * wgt[:, :, :, i, j, None]
    return acc.to(dtype)


@functools.cache
def _lib():
    lib = _build.load("adaptive_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.naf_adaptive_conv_max_k.argtypes = []
    lib.naf_adaptive_conv_max_k.restype = i32
    lib.naf_adaptive_conv_narrow.argtypes = [ptr] * 3 + [i32] * 6 + [ctypes.c_longlong, i32, ptr]
    lib.naf_adaptive_conv_narrow.restype = i32
    lib.naf_adaptive_conv_wide.argtypes = [ptr] * 3 + [i32] * 9 + [ctypes.c_longlong, i32, ptr]
    lib.naf_adaptive_conv_wide.restype = i32
    if lib.naf_adaptive_conv_max_k() != MAX_K:
        raise RuntimeError("adaptive_conv.cu's largest k does not match MAX_K")
    return lib


def _launch(source_padded, kernel):
    """Launch K5 on CUDA tensors."""
    if source_padded.device.type != "cuda" or kernel.device != source_padded.device:
        raise ValueError(f"K5 launches on CUDA tensors on one device, got "
                         f"{source_padded.device} and {kernel.device}")
    b, h, w, c, kh, kw = _shapes(source_padded, kernel)
    if kh != kw or kh % 2 != 1 or kh > MAX_K:
        raise ValueError(f"K5 takes square kernels of odd size up to {MAX_K}, got {kh}x{kw}")
    if b > 65535:
        raise ValueError(f"K5 takes at most 65535 samples per launch, got {b}")
    dtype = torch.promote_types(source_padded.dtype, kernel.dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 computes in float32 or bfloat16, got {dtype}")
    src = source_padded.to(dtype).contiguous()
    wgt = kernel.float().contiguous()
    out = torch.empty((b, h, w, c), dtype=dtype, device=src.device)
    if out.numel() == 0:
        return out
    plan = _plan_k5(b, h, w, c, kh, dtype)
    is_bf16 = int(dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        if plan.route == "narrow":
            err = _lib().naf_adaptive_conv_narrow(
                src.data_ptr(), wgt.data_ptr(), out.data_ptr(), b, h, w, c, kh, plan.tile[1],
                plan.smem, is_bf16, stream)
        else:
            # 16-byte cp.async pieces of a stage need whole pieces of channels
            vec = int((c * src.element_size()) % 16 == 0 and src.data_ptr() % 16 == 0)
            err = _lib().naf_adaptive_conv_wide(
                src.data_ptr(), wgt.data_ptr(), out.data_ptr(), b, h, w, c, kh, plan.tile[0],
                plan.grid[1], plan.stages, vec, plan.smem, is_bf16, stream)
    if err:
        raise RuntimeError(f"adaptive_conv {plan.route} kernel launch failed: cudaError {err}")
    adaptive_conv_fused.launches += 1
    adaptive_conv_fused.route_launches[plan.route] += 1
    return out


def adaptive_conv_fused(source_padded, kernel):
    """Spatially varying conv (not differentiable; see ``ops.adaptive_conv``).

    source_padded (B, H+k-1, W+k-1, C), kernel (B, H, W, k, k) -> (B, H, W, C)
    in ``promote(source, kernel)``. CPU tensors take the plain version; CUDA
    tensors launch K5."""
    if source_padded.device.type == "cpu":
        return adaptive_conv_fused_ref(source_padded, kernel)
    return _launch(source_padded, kernel)


adaptive_conv_fused.launches = 0
adaptive_conv_fused.route_launches = {"narrow": 0, "wide": 0}
