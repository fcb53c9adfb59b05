"""Fused encoder layers: kernel K1 and the torch glue around it.

Counterpart of ``naf_tpu/kernels/encoder_fused.py``. The NAF image encoder is
a chain of [GroupNorm -> SiLU -> reflect conv] layers. Each layer runs as ONE
kernel (``csrc/encoder_fused.cu``):

    y = conv_k(silu(x * scale + shift)) + bias      (+ f32 channel sums of y)

where scale/shift fold the GroupNorm normalisation and affine into a
per-sample, per-channel multiply-add, finalised from the previous layer's
channel sums by :func:`_gn_affine`, so GroupNorm never takes a pass over the
activations. Each stack's stem (3 -> F) is one launch of a second kernel in
the same library, :func:`stem_conv_fused`: the conv, its bias and the io-dtype
roundings, with the first GroupNorm's channel sums on K1's own tiles. The
JAX package computes the stem as plain XLA; that kernel replaces none.

:func:`encoder_stack_fused_packed` runs the pixel (k=1) and semantic (k=3)
stacks and has each stack's last layer write its half of one
(B, H, W, 2*hidden) buffer, so the pix|sem concat never happens. Every
encoder route (the whole stacks, a spatial band in ``parallel``, the banded
encoder of ``encoder_banded``) runs one chain, :func:`_chain`, which decides
in one place between the kernels and their plain versions. Kernel K6
(``csrc/encoder_dual.cu``: both stacks' layer over a packed [pix|sem]
buffer in one launch) is the counterpart of the JAX package's dual kernel;
it lost to the K1 pair on the card and no route of the encoder takes it.

Every function has a plain PyTorch version beside it (``*_ref``). The
wrappers take it for CPU tensors only; for CUDA tensors they launch the
kernel or raise. Their backward recomputes through the plain version, as
the JAX package's custom VJPs do.

On CUDA, K1 and K6 each have two kernels, chosen from the io dtype alone
(:func:`_route`): bf16 runs an implicit GEMM on Hopper's tensor cores
(``csrc/encoder_tc.cuh``, weights packed by :func:`pack_weights_tc`), f32
the CUDA-core kernel, exact to the reference in f32. Both write the
partial sums of the same pixel tiles (:func:`tile_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from naf_torch.kernels import _build
from naf_torch.utils.spans import span, to_device

__all__ = [
    "gn_silu_conv_fused",
    "gn_silu_conv_ref",
    "gn_silu_conv_dual_fused",
    "gn_silu_conv_dual_ref",
    "encoder_stack_band",
    "encoder_stack_fused",
    "encoder_stack_fused_packed",
    "encoder_stack_ref",
    "pack_weights_tc",
    "stem_conv_fused",
    "stem_conv_ref",
    "stem_tile_sums_ref",
    "tile_plan",
]

# The kernels' output tile (rows, columns): the partial sums are per tile.
TILE = (8, 16)
# Tensor-core kernels: input channels per weight stage, one 128-byte row of
# bf16 (the swizzle's width).
TC_KB = 64


def _gn_affine(psums, gamma, beta, hw: int, num_groups: int, eps: float):
    """Fold GroupNorm stats + affine into per-sample (B, C) f32 scale/shift.

    psums: (B, 2, C) f32 [sum, sumsq] over (H, W). gn(x) = x * scale + shift
    (biased variance as E[y^2] - E[y]^2, contiguous channel groups)."""
    b, _, c = psums.shape
    cg = c // num_groups
    count = hw * cg
    s = psums.reshape(b, 2, num_groups, cg).sum(dim=-1)  # (B, 2, G)
    mean = s[:, 0] / count
    var = s[:, 1] / count - mean * mean
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=-1)
    rstd_c = rstd.repeat_interleave(cg, dim=-1)
    scale = rstd_c * gamma.float()[None]
    shift = beta.float()[None] - mean_c * scale
    return scale, shift


def _channel_sums(x):
    """(B, H, W, C) -> (B, 2, C) f32 [sum, sumsq]."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))], dim=1)


def _conv_nhwc(x, weight, bias=None):
    """f32 reflect-'same' conv of an NHWC tensor with an (F, C, k, k) weight."""
    p = weight.shape[-1] // 2
    xc = x.permute(0, 3, 1, 2).float()
    if p:
        xc = F.pad(xc, (p, p, p, p), mode="reflect")
    b = None if bias is None else bias.float()
    return F.conv2d(xc, weight.float(), b).permute(0, 2, 3, 1)


def _stem_conv(x, weight, bias):
    """Stem conv (3 -> F). The f32 accumulator rounds to the io dtype before
    the bias add, as the JAX package's ``_stem_conv_matmul`` does."""
    y = _conv_nhwc(x, weight).to(x.dtype) + bias.to(x.dtype)
    return y.contiguous()


def tile_plan(h: int, w: int, k: int):
    """The kernels' pixel tiles: (tiles_h, tiles_w, rows, cols). rows[ty] are
    the source rows of tile row ty's halo, TILE[0] + k - 1 of them, reflected
    at the image edge as torch's reflect padding and clamped past a ragged
    edge (those pixels' outputs are never stored); cols likewise. The kernels
    compute the same indices on the card (``reflect`` in
    ``csrc/encoder_common.cuh``)."""
    p = k // 2

    def src(n, t):
        tiles = -(-n // t)
        i = torch.arange(tiles)[:, None] * t + torch.arange(t + 2 * p)[None, :] - p
        i = torch.where(i < 0, -i, i)
        i = torch.where(i >= n, 2 * n - 2 - i, i)
        return tiles, i.clamp(0, n - 1)

    tiles_h, rows = src(h, TILE[0])
    tiles_w, cols = src(w, TILE[1])
    return tiles_h, tiles_w, rows, cols


def _tc_steps(c: int, k: int):
    """(tap, 64-channel block) of each weight stage, in stream order: blocks,
    then taps (row-major)."""
    return [(tap, cb) for cb in range(-(-c // TC_KB)) for tap in range(k * k)]


def pack_weights_tc(weights, n_block: int):
    """The tensor-core kernels' B operand: each (F, C, k, k) weight as a
    stream of stages, the weights' streams back to back,
    (ceil(F / n_block), steps, n_block, TC_KB).

    Stage s of output-channel block fb holds, at row n and column kk,
    weight[fb * n_block + n, 64 * cb + kk, ky, kx] for the (tap, cb) of
    :func:`_tc_steps` (zero past F or C). A row is 128 bytes of bf16 in
    16-byte chunks, chunk j stored at position j ^ (n % 8): wgmma's 128-byte
    swizzle of a K-major operand, 8-row atoms 1024 bytes apart."""
    out = []
    for w in weights:
        f, c, k, _ = w.shape
        nb = -(-f // n_block)
        blocks = -(-c // TC_KB)
        wp = w.new_zeros(nb * n_block, blocks * TC_KB, k, k)
        wp[:f, :c] = w
        wp = wp.reshape(nb, n_block, blocks, TC_KB, k * k)
        taps, cbs = zip(*_tc_steps(c, k))
        st = wp[:, :, list(cbs), :, list(taps)].permute(1, 0, 2, 3)  # (nb, steps, N, KB)
        st = st.reshape(nb, len(taps), n_block, TC_KB // 8, 8)
        logical = torch.arange(TC_KB // 8)[None, :] ^ (torch.arange(n_block) % 8)[:, None]
        st = st.gather(3, logical[None, None, :, :, None].expand(st.shape))
        out.append(st.reshape(nb, len(taps), n_block, TC_KB))
    return torch.cat(out, dim=1)


@functools.lru_cache(maxsize=64)
def _pack_index(shapes, n_block: int, device):
    """:func:`pack_weights_tc` as a gather: indices into the weights'
    flattened concatenation, the padding's entries at its end (one past the
    last weight element), and whether there is padding; built once per
    shape and device."""
    src, start = [], 1
    for shape in shapes:
        n = math.prod(shape)
        src.append(torch.arange(start, start + n).reshape(shape))
        start += n
    idx = pack_weights_tc(src, n_block).flatten() - 1
    padded = bool((idx < 0).any())
    return to_device(torch.where(idx < 0, start - 1, idx), device), padded


def _packed(weights, n_block: int, dtype):
    """pack_weights_tc(weights, n_block) in ``dtype`` on the weights' device:
    one gather, over the weights themselves where there is no padding."""
    idx, padded = _pack_index(tuple(tuple(w.shape) for w in weights), n_block,
                              weights[0].device)
    flat = [w.detach().to(dtype).reshape(-1) for w in weights]
    if padded:
        flat.append(flat[0].new_zeros(1))
    return torch.take(flat[0] if len(flat) == 1 else torch.cat(flat), idx)


def _route(dtype) -> str:
    """Which kernel a CUDA tensor of this io dtype launches, decided from the
    dtype alone: bf16 the tensor-core implicit GEMM ("wgmma"), f32 the
    CUDA-core kernel ("fma")."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"K1 and K6 take float32 or bfloat16, got {dtype}")


def _gn_silu_conv_f32(x, scale, shift, weight, bias):
    """K1's plain math up to its f32 conv output, before y rounds to x's
    dtype: (B,H,W,F) f32."""
    # x * f32 scale promotes to f32 (the same values as x.float() * scale) and
    # saves x for the backward in its own dtype, not an f32 copy
    z = x * scale.float()[..., None, None, :] + shift.float()[..., None, None, :]
    z = F.silu(z).to(x.dtype)  # the activated input rounds to the io dtype
    return _conv_nhwc(z, weight, bias)


def gn_silu_conv_ref(x, scale, shift, weight, bias):
    """Plain version of K1. x (B,H,W,C); scale/shift (B,C) or (C,) f32;
    weight (F,C,k,k); bias (F,). Returns (y (B,H,W,F) in x's dtype,
    psums (B,2,F) f32 of the f32 y)."""
    y = _gn_silu_conv_f32(x, scale, shift, weight, bias)
    return y.to(x.dtype), _channel_sums(y)


@functools.cache
def _lib():
    lib = _build.load("encoder_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.naf_gn_silu_conv_tiles.argtypes = [i32, i32]
    lib.naf_gn_silu_conv_tiles.restype = i32
    lib.naf_gn_silu_conv_fma.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
    lib.naf_gn_silu_conv_fma.restype = i32
    lib.naf_gn_silu_conv_wgmma.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
    lib.naf_gn_silu_conv_wgmma.restype = i32
    lib.naf_stem_conv.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.naf_stem_conv.restype = i32
    return lib


def _launch(x, scale, shift, weight, bias, out=None, out_off: int = 0):
    """Launch K1 on CUDA tensors. With ``out`` (B,H,W,total), y is written at
    channels [out_off, out_off + F) of it. Returns (out, psums)."""
    if x.device.type != "cuda":
        raise ValueError(f"K1 launches on CUDA tensors, got {x.device}")
    route = _route(x.dtype)
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("K1 takes a contiguous NHWC tensor")
    b, h, w, c = x.shape
    f, ci, k, k2 = weight.shape
    if ci != c or k != k2 or k not in (1, 3):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x {tuple(x.shape)}")
    if k == 3 and min(h, w) < 2:
        raise ValueError("reflect padding needs H, W >= 2")
    for t in (scale, shift, weight, bias):
        if t.device != x.device:
            raise ValueError("all K1 inputs must be on one device")
    if bias.shape != (f,):
        raise ValueError(f"bias {tuple(bias.shape)} must be ({f},)")
    if scale.shape not in ((b, c), (c,)) or shift.shape not in ((b, c), (c,)):
        raise ValueError(f"scale/shift must be ({b}, {c}) or ({c},)")
    sc = scale.float().expand(b, c).contiguous()
    sh = shift.float().expand(b, c).contiguous()
    b32 = bias.float().contiguous()
    if out is not None and (out.ndim != 4 or out.shape[:3] != x.shape[:3]
                            or out.dtype != x.dtype or not out.is_contiguous()
                            or out_off + f > out.shape[3]):
        raise ValueError("packed output buffer does not fit this layer")
    if c % 16 or f % 64:
        return _launch_padded(x, sc, sh, weight, b32, out, out_off)
    if out is not None and (out.shape[3] % 8 or out_off % 8):
        raise ValueError("the kernels write 16-byte chunks: the packed output's channels and "
                         "offset must be multiples of 8")
    if out is None:
        out = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    lib = _lib()
    part = torch.empty((b, lib.naf_gn_silu_conv_tiles(h, w), 2, f), dtype=torch.float32,
                       device=x.device)
    ptrs = [x.data_ptr(), sc.data_ptr(), sh.data_ptr()]
    tail = [b32.data_ptr(), out.data_ptr(), part.data_ptr(), b, h, w, c, f, k]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            n_block = 128 if f % 128 == 0 else 64
            wk = _packed((weight,), n_block, x.dtype)
            err = lib.naf_gn_silu_conv_wgmma(*ptrs, wk.data_ptr(), *tail, n_block, out.shape[3],
                                             out_off, stream)
        else:
            w_taps = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(k * k, c, f).contiguous()
            err = lib.naf_gn_silu_conv_fma(*ptrs, w_taps.data_ptr(), *tail, out.shape[3],
                                           out_off, stream)
    if err:
        raise RuntimeError(f"encoder_fused kernel launch failed: cudaError {err}")
    gn_silu_conv_fused.launches += 1
    return out, part.sum(dim=1)


def _pad_layer(x, sc, sh, weight, bias):
    """K1's operands with C padded to a multiple of 16 and F to one of 64:
    the extra input channels are zeros with scale = shift = 0 (SiLU(0) = 0)
    meeting zero weights, and the extra output channels have zero weights
    and bias, so y and its sums over the first F channels are unchanged."""
    c, f = x.shape[-1], weight.shape[0]
    pc, pf = -c % 16, -f % 64
    return (F.pad(x, (0, pc)), F.pad(sc, (0, pc)), F.pad(sh, (0, pc)),
            F.pad(weight, (0, 0, 0, 0, 0, pc, 0, pf)), F.pad(bias, (0, pf)))


def _launch_padded(x, sc, sh, weight, bias, out=None, out_off: int = 0):
    """K1 at a width the kernels do not take (C % 16, F % 64): one launch on
    zero-padded operands, then y and the sums sliced back to F (into ``out``
    at ``out_off`` when given)."""
    f = weight.shape[0]
    y, ps = _launch(*_pad_layer(x, sc, sh, weight, bias))
    if out is None:
        return y[..., :f].contiguous(), ps[..., :f]
    out[..., out_off : out_off + f] = y[..., :f]
    return out, ps[..., :f]


def _grads(outputs, grad_outputs, inputs):
    """autograd.grad over the inputs that need it (None for the rest)."""
    need = [t for t in inputs if t.requires_grad]
    pairs = [(o, g if g is not None else torch.zeros_like(o))
             for o, g in zip(outputs, grad_outputs)]
    got = iter(torch.autograd.grad([o for o, _ in pairs], need, [g for _, g in pairs],
                                   allow_unused=True))
    return [next(got) if t.requires_grad else None for t in inputs]


def _detached(tensors, ctx):
    return [t.detach().requires_grad_(need) for t, need in
            zip(tensors, ctx.needs_input_grad)]


class _GnSiluConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, weight, bias):
        ctx.save_for_backward(x, scale, shift, weight, bias)
        return _launch(x, scale, shift, weight, bias)

    @staticmethod
    def backward(ctx, gy, gps):
        inputs = _detached(ctx.saved_tensors, ctx)
        with torch.enable_grad():
            outs = gn_silu_conv_ref(*inputs)
        return tuple(_grads(outs, (gy, gps), inputs))


def gn_silu_conv_fused(x, scale, shift, weight, bias):
    """One fused encoder layer: (y (B,H,W,F), psums (B,2,F) f32).

    x (B,H,W,C) f32/bf16; scale/shift (B,C) or (C,); weight (F,C,k,k), k in
    {1,3}; bias (F,). CPU tensors take the plain version; CUDA tensors launch
    K1 (count in ``gn_silu_conv_fused.launches``)."""
    if x.device.type == "cpu":
        return gn_silu_conv_ref(x, scale, shift, weight, bias)
    return _GnSiluConv.apply(x, scale, shift, weight, bias)


gn_silu_conv_fused.launches = 0


def stem_conv_ref(x, weight, bias):
    """Plain version of the stem kernel: (y (B,H,W,F) in x's dtype, psums
    (B,2,F) f32 of that rounded y), by :func:`_stem_conv` and
    :func:`_channel_sums`."""
    y = _stem_conv(x, weight, bias)
    return y, _channel_sums(y)


def stem_tile_sums_ref(y):
    """What the stem kernel writes before its wrapper sums the tiles: f32
    [sum, sum of squares] of y (B,H,W,F) over each tile of
    :func:`tile_plan`, tiles row-major, (B, tiles, 2, F), in f32 or, for a
    float64 y, in float64."""
    b, h, w, f = y.shape
    tiles_h, tiles_w, _, _ = tile_plan(h, w, 1)
    yf = F.pad(y.to(torch.promote_types(y.dtype, torch.float32)),
               (0, 0, 0, tiles_w * TILE[1] - w, 0, tiles_h * TILE[0] - h))
    t = yf.reshape(b, tiles_h, TILE[0], tiles_w, TILE[1], f)
    sums = torch.stack([t.sum(dim=(2, 4)), (t * t).sum(dim=(2, 4))], dim=3)
    return sums.reshape(b, tiles_h * tiles_w, 2, f)


def _stem_shape_error(x_shape, weight_shape, bias_shape, contiguous: bool = True):
    """Why the stem kernel cannot take these operands, or None: a contiguous
    NHWC image of 3 channels, an (F, 3, k, k) weight with k in {1, 3}, an
    (F,) bias, and H, W >= 2 where k = 3 (reflect padding)."""
    if len(x_shape) != 4 or not contiguous:
        return "the stem kernel takes a contiguous NHWC image"
    _, h, w, c = x_shape
    if c != 3:
        return f"the stem kernel takes 3 image channels, got {c}"
    if len(weight_shape) != 4 or tuple(weight_shape[1:]) not in ((3, 1, 1), (3, 3, 3)):
        return f"weight {tuple(weight_shape)} must be (F, 3, k, k) with k in (1, 3)"
    if tuple(bias_shape) != (weight_shape[0],):
        return f"bias {tuple(bias_shape)} must be ({weight_shape[0]},)"
    if weight_shape[-1] == 3 and min(h, w) < 2:
        return "reflect padding needs H, W >= 2"
    return None


def _launch_stem_tiles(x, weight, bias):
    """Launch the stem kernel on CUDA tensors: (y, its per-tile partials
    (B, tiles, 2, F)). F not a multiple of 8 runs on weights and a bias
    zero-padded to one (16-byte stores), then is sliced back."""
    if x.device.type != "cuda":
        raise ValueError(f"the stem kernel launches on CUDA tensors, got {x.device}")
    io_bf16 = _route(x.dtype) == "wgmma"
    err = _stem_shape_error(x.shape, weight.shape, bias.shape, x.is_contiguous())
    if err:
        raise ValueError(err)
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("all stem inputs must be on one device")
    f, k = weight.shape[0], weight.shape[-1]
    if f % 8:
        pf = -f % 8
        y, part = _launch_stem_tiles(x, F.pad(weight, (0, 0, 0, 0, 0, 0, 0, pf)),
                                     F.pad(bias, (0, pf)))
        return y[..., :f].contiguous(), part[..., :f]
    b, h, w, _ = x.shape
    # in the io dtype, as K1's weights; the model's forward casts its inputs
    # to its parameters' dtype, so this copies nothing there. The bias rounds
    # to it in _stem_conv too.
    weight = weight.to(x.dtype).contiguous()
    bias = bias.to(x.dtype).contiguous()
    lib = _lib()
    y = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    part = torch.empty((b, lib.naf_gn_silu_conv_tiles(h, w), 2, f), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = lib.naf_stem_conv(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                part.data_ptr(), b, h, w, f, k, int(io_bf16),
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stem kernel launch failed: cudaError {err}")
    stem_conv_fused.launches += 1
    return y, part


def _launch_stem(x, weight, bias):
    """The stem kernel: (y, psums (B,2,F)), its tiles summed as K1's are."""
    y, part = _launch_stem_tiles(x, weight, bias)
    return y, part.sum(dim=1)


def stem_conv_fused(x, weight, bias):
    """The encoder's stem: (y (B,H,W,F) in x's dtype, psums (B,2,F) f32 of
    that rounded y), for x (B,H,W,3) f32/bf16, weight (F,3,k,k) with k in
    {1,3} and bias (F,). CPU tensors take :func:`stem_conv_ref`; CUDA
    tensors launch the stem kernel (count in ``stem_conv_fused.launches``),
    inference-only: the stacks' gradient is their plain twin's."""
    if x.device.type == "cpu":
        return stem_conv_ref(x, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise NotImplementedError("the stem kernel is inference-only; differentiate "
                                  "encoder_stack_fused_packed instead")
    return _launch_stem(x, weight, bias)


stem_conv_fused.launches = 0


def gn_silu_conv_dual_ref(x, scale, shift, wp, ws, bp, bs):
    """Plain version of K6: one packed dual-stack layer. x (B,H,W,2C) is
    [pix|sem]; scale/shift (B,2C) or (2C,) f32; wp (C,C,1,1) the pixel
    stack's 1x1 weight, ws (C,C,3,3) the semantic stack's 3x3 weight; bp, bs
    (C,). Returns (y (B,H,W,2C) in x's dtype, psums (B,2,2C) f32 of the f32 y)."""
    c = x.shape[-1] // 2
    # x * f32 scale promotes to f32 (the same values as x.float() * scale) and
    # saves x for the backward in its own dtype, not an f32 copy
    z = x * scale.float()[..., None, None, :] + shift.float()[..., None, None, :]
    z = F.silu(z).to(x.dtype)  # the activated input rounds to the io dtype
    y = torch.cat([_conv_nhwc(z[..., :c], wp, bp), _conv_nhwc(z[..., c:], ws, bs)], dim=-1)
    return y.to(x.dtype), _channel_sums(y)


def _dual_shape_error(x_shape, wp_shape, ws_shape):
    """Why K6 cannot take these shapes, or None: 2C packed channels with
    C % 16 == 0 (whole channel stages and 16-byte stores), a 1x1 pixel and a
    3x3 semantic weight of C -> C, and H, W >= 2 (reflect padding)."""
    if len(x_shape) != 4:
        return "K6 takes an NHWC tensor"
    _, h, w, c2 = x_shape
    c = c2 // 2
    if c2 % 2 or c % 16 or c == 0:
        return f"K6 needs 2C packed channels with C % 16 == 0, got {c2}"
    if tuple(wp_shape) != (c, c, 1, 1) or tuple(ws_shape) != (c, c, 3, 3):
        return (f"weights {tuple(wp_shape)} / {tuple(ws_shape)} must be ({c}, {c}, 1, 1) / "
                f"({c}, {c}, 3, 3)")
    if min(h, w) < 2:
        return "reflect padding needs H, W >= 2"
    return None


@functools.cache
def _dual_lib():
    lib = _build.load("encoder_dual")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.naf_gn_silu_conv_dual_tiles.argtypes = [i32, i32]
    lib.naf_gn_silu_conv_dual_tiles.restype = i32
    lib.naf_gn_silu_conv_dual_fma.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.naf_gn_silu_conv_dual_fma.restype = i32
    lib.naf_gn_silu_conv_dual_wgmma.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.naf_gn_silu_conv_dual_wgmma.restype = i32
    return lib


def _launch_dual(x, scale, shift, wp, ws, bp, bs):
    """Launch K6 on CUDA tensors. Returns (y (B,H,W,2C), psums (B,2,2C))."""
    if x.device.type != "cuda":
        raise ValueError(f"K6 launches on CUDA tensors, got {x.device}")
    route = _route(x.dtype)
    if not x.is_contiguous():
        raise ValueError("K6 takes a contiguous NHWC tensor")
    err = _dual_shape_error(x.shape, wp.shape, ws.shape)
    if err:
        raise ValueError(err)
    for t in (scale, shift, wp, ws, bp, bs):
        if t.device != x.device:
            raise ValueError("all K6 inputs must be on one device")
    b, h, w, c2 = x.shape
    c = c2 // 2
    if bp.shape != (c,) or bs.shape != (c,):
        raise ValueError(f"biases {tuple(bp.shape)} / {tuple(bs.shape)} must be ({c},)")
    if scale.shape not in ((b, c2), (c2,)) or shift.shape not in ((b, c2), (c2,)):
        raise ValueError(f"scale/shift must be ({b}, {c2}) or ({c2},)")
    bias = torch.cat([bp, bs]).float().contiguous()
    sc = scale.float().expand(b, c2).contiguous()
    sh = shift.float().expand(b, c2).contiguous()
    lib = _dual_lib()
    out = torch.empty_like(x)
    part = torch.empty((b, lib.naf_gn_silu_conv_dual_tiles(h, w), 2, c2), dtype=torch.float32,
                       device=x.device)
    ptrs = [x.data_ptr(), sc.data_ptr(), sh.data_ptr()]
    tail = [bias.data_ptr(), out.data_ptr(), part.data_ptr(), b, h, w, c]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            n_block = 128 if c > 64 else 64
            wk = _packed((wp, ws), n_block, x.dtype)
            err = lib.naf_gn_silu_conv_dual_wgmma(*ptrs, wk.data_ptr(), *tail, n_block, stream)
        else:
            wp_t = wp.to(x.dtype).reshape(c, c).t().contiguous()  # (in, out)
            ws_t = ws.to(x.dtype).permute(2, 3, 1, 0).reshape(9, c, c).contiguous()
            err = lib.naf_gn_silu_conv_dual_fma(*ptrs, wp_t.data_ptr(), ws_t.data_ptr(), *tail,
                                                stream)
    if err:
        raise RuntimeError(f"encoder_dual kernel launch failed: cudaError {err}")
    gn_silu_conv_dual_fused.launches += 1
    return out, part.sum(dim=1)


def gn_silu_conv_dual_fused(x, scale, shift, wp, ws, bp, bs):
    """One packed dual-stack layer: (y (B,H,W,2C), psums (B,2,2C) f32),
    arguments as in :func:`gn_silu_conv_dual_ref`. CPU tensors take the
    plain version; CUDA tensors launch K6 (count in
    ``gn_silu_conv_dual_fused.launches``), inference-only."""
    if x.device.type == "cpu":
        return gn_silu_conv_dual_ref(x, scale, shift, wp, ws, bp, bs)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, shift, wp, ws, bp, bs)):
        raise NotImplementedError("K6 is inference-only; differentiate "
                                  "encoder_stack_fused_packed instead")
    return _launch_dual(x, scale, shift, wp, ws, bp, bs)


gn_silu_conv_dual_fused.launches = 0


def _stack_params(encoder):
    """Flat parameter list of an ``Encoder``: stem, then per block
    norm1, conv1, norm2, conv2 (weight, bias each)."""
    params = [encoder[0].weight, encoder[0].bias]
    for blk in list(encoder)[1:]:
        for m in (blk.norm1, blk.conv1, blk.norm2, blk.conv2):
            params += [m.weight, m.bias]
    return params


def _stack_spec(encoder):
    if encoder.residual or encoder[0].bias is None:
        raise ValueError("K1 runs NAF's encoder stacks: no residual, convs with biases")
    return (encoder.num_layers, encoder.num_groups, encoder.eps)


def _split(params, specs):
    """Per-stack slices of the flat parameter list."""
    out, i = [], 0
    for spec in specs:
        n = 2 + 8 * spec[0]
        out.append(params[i : i + n])
        i += n
    return out


def _takes_kernels(x, twin: bool) -> bool:
    """The encoder's one route decision: CUDA tensors launch the stem kernel
    and K1; CPU tensors, and the backward's plain twin (``twin``), take
    their plain versions."""
    return x.is_cuda and not twin


def _chain(x, params, spec, rows=None, depth=None, stats=None, out=None, out_off: int = 0,
           twin: bool = False):
    """One stack from the image ``x`` (B, H, W, 3): its stem, then its first
    ``depth`` (by default all 2*num_layers) GN -> SiLU -> conv layers, each
    GroupNorm folded by :func:`_gn_affine` from channel sums (B, 2, C)
    [sum, sumsq]. Every encoder route runs this chain: on the stem kernel
    and K1 where :func:`_takes_kernels` says so, else on their plain
    versions. The kernels are inference-only: a forward that autograd
    records goes through :class:`_FusedStacks` or :class:`_FusedBand`,
    whose backward differentiates the twin.

    ``rows``: None for the whole image, else (r0, r1): those output rows,
    computed from image rows [r0 - halo, r1 + halo), halo = k_stem//2 + the
    layers' k//2. At an interior band edge each conv's reflect padding is
    wrong, but the rows it reaches stay in the halo and are cut at the end,
    so no kept row reads them and they get no gradient.

    ``stats``: None, each layer's channel sums are the layer before's own
    over the whole image (the kernels' tile sums; in the plain version,
    those of the f32 conv output). Else ``stats(i, f)`` gives layer i's sums
    from ``f``, the layer before's output on rows [r0, r1) (on the kernels
    the rounded y, in the plain version the f32 conv output): the band's
    own sums through a reduction, or the whole image's from the streamed
    encoder's sweeps (``encoder_banded.encoder_stack_stats``).

    With ``out`` the last layer writes at channels [out_off, out_off + F)
    of ``out`` (B, H, W, total), which is returned."""
    num_layers, num_groups, eps = spec
    layers = [params[i : i + 4] for i in range(2, 2 + 8 * num_layers, 4)][:depth]
    _, h, w, _ = x.shape
    r0, r1 = rows or (0, h)
    a = 0
    if rows is not None:
        halo = params[0].shape[-1] // 2 + sum(weight.shape[-1] // 2 for _, _, weight, _ in layers)
        a = max(0, r0 - halo)
        x = x[:, a : min(h, r1 + halo)].contiguous()
    kernels = _takes_kernels(x, twin)
    if kernels and torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise NotImplementedError("the encoder's kernels are inference-only; differentiate "
                                  "encoder_stack_fused_packed or encoder_stack_band instead")
    if kernels and stats is None:
        y, ps = _launch_stem(x, params[0], params[1])
    elif kernels:
        y, _ = _launch_stem_tiles(x, params[0], params[1])  # the band's sums come from stats
    else:
        y = _stem_conv(x, params[0], params[1])
        ps = _channel_sums(y) if stats is None else None
    f = y
    for i, (gamma, beta, weight, bias) in enumerate(layers):
        if stats is not None:
            ps = stats(i, f[:, r0 - a : r1 - a])
        scale, shift = _gn_affine(ps, gamma, beta, h * w, num_groups, eps)
        last = out is not None and i == len(layers) - 1
        if kernels:
            y, ps = _launch(y, scale, shift, weight, bias, *((out, out_off) if last else ()))
            f = y
        else:
            f = _gn_silu_conv_f32(y, scale, shift, weight, bias)
            y = f.to(y.dtype)
            ps = _channel_sums(f) if stats is None else None
            if last:
                out[..., out_off : out_off + y.shape[-1]] = y
                y = out
    return y if rows is None else y[:, r0 - a : r1 - a]


def _stacks_ref(x, params, specs):
    """The stacks' plain twin, their outputs concatenated."""
    outs = [_chain(x, p, spec, twin=True) for p, spec in zip(_split(params, specs), specs)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


# Saved tensors of fewer elements stay as they are (weights, statistics).
_PACK_MIN = 1 << 20


def _pack_exact_bf16(t):
    """saved_tensors_hooks pack for the bf16 twin's recompute: an f32 tensor
    made by widening a bf16 one (``ToCopyBackward0``: the conv input of
    ``_conv_nhwc``, the channel sums' input), or a reflect pad of one, holds
    only bf16 values, so it is kept as bf16, half the bytes, and widened back
    exactly when the backward reads it. In the twin every widening copy to
    f32 starts from bf16 (its inputs and parameters are bf16; the f32
    statistics are never copied to f32 again). Any other tensor is kept as
    it is."""
    fn = t.grad_fn
    if t.dtype == torch.float32 and t.numel() >= _PACK_MIN and fn is not None:
        if fn.name() == "ReflectionPad2DBackward0":
            fn = fn.next_functions[0][0]
        if fn is not None and fn.name() == "ToCopyBackward0":
            return t.to(torch.bfloat16), True
    return t, False


def _unpack_exact_bf16(packed):
    t, narrowed = packed
    return t.float() if narrowed else t


def _recompute_grads(saved, needs, twin, g):
    """The gradients of the plain twin ``twin(x, params)`` at the saved
    input and parameters. With a bf16 input the recompute keeps its f32
    widenings of bf16 activations as bf16 (:func:`_pack_exact_bf16`): the
    backward reads the same values, and the twin's saved activations take
    less memory (the JAX package's twin saves bf16 activations: its convs
    run in bf16)."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
    with torch.enable_grad():
        if inputs[0].dtype == torch.bfloat16:
            with torch.autograd.graph.saved_tensors_hooks(_pack_exact_bf16,
                                                          _unpack_exact_bf16):
                out = twin(inputs[0], inputs[1:])
        else:
            out = twin(inputs[0], inputs[1:])
    return _grads((out,), (g,), inputs)


def _twin_grads(saved, needs, specs, g):
    """The gradients of the stacks' plain twin (``_stacks_ref``) at the
    saved input and parameters (:func:`_recompute_grads`)."""
    return _recompute_grads(saved, needs, lambda x, params: _stacks_ref(x, params, specs), g)


class _FusedStacks(torch.autograd.Function):
    """One or more encoder stacks (:func:`_chain`), their outputs packed
    side by side in one buffer by the last layer of each. The backward
    differentiates the plain per-stack twin, as the JAX package's
    ``_packed_vjp_bwd`` does."""

    @staticmethod
    def forward(ctx, x, specs, *params):
        ctx.specs = specs
        ctx.save_for_backward(x, *params)
        stacks = _split(params, specs)
        hidden = [p[0].shape[0] for p in stacks]  # stem weight (F, 3, k, k)
        b, h, w, _ = x.shape
        out = torch.empty((b, h, w, sum(hidden)), dtype=x.dtype, device=x.device)
        off = 0
        for p, spec, hd in zip(stacks, specs, hidden):
            _chain(x, p, spec, out=out, out_off=off)
            off += hd
        return out

    @staticmethod
    def backward(ctx, g):
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[2:]
        with span("naf.encoder.backward"):
            grads = _twin_grads(ctx.saved_tensors, needs, ctx.specs, g)
        return (grads[0], None, *grads[1:])


class _FusedBand(torch.autograd.Function):
    """One stack's band (:func:`_chain` over rows [r0, r1), its statistics
    through ``reduce_sums``), differentiated through the plain twin
    recomputed from the image rows, as :class:`_FusedStacks` differentiates
    a whole stack. The gradient that reaches a conv's output from the next
    layer and from the GroupNorm statistics (two terms that nearly cancel)
    is summed in f32 and stays f32 through that conv's weight gradient; a
    chain of per-layer K1 gradients would round it to bf16 at each K1 output
    and lose most of the earlier layers' gradients (5-10x the twin's error
    in bf16). In bf16 the kernels' statistics are sums of the rounded y
    (K1's own sums cover every held row, halo included), the twin's of the
    f32 conv output: the backward differentiates a function a rounding away
    from the one the forward computed (f32 is exact)."""

    @staticmethod
    def forward(ctx, x, spec, r0, r1, reduce_sums, *params):
        ctx.band = (spec, r0, r1, reduce_sums)
        ctx.save_for_backward(x, *params)
        return _chain(x, params, spec, (r0, r1), stats=_band_stats(reduce_sums))

    @staticmethod
    def backward(ctx, g):
        spec, r0, r1, reduce_sums = ctx.band
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[5:]
        grads = _recompute_grads(ctx.saved_tensors, needs, lambda x, params: _chain(
            x, params, spec, (r0, r1), stats=_band_stats(reduce_sums), twin=True), g)
        return (grads[0], None, None, None, None, *grads[1:])


def _band_stats(reduce_sums):
    """:func:`_chain`'s ``stats`` for a band: the channel sums of its own
    rows, through ``reduce_sums``."""
    return lambda i, f: reduce_sums(_channel_sums(f))


def encoder_stack_band(encoder, x, r0: int, r1: int, reduce_sums):
    """Rows [r0, r1) of one stack's output from the image ``x`` (B, H, W,
    3), computed on those rows plus a halo, with each GroupNorm's channel
    sums over the band's own rows passed through ``reduce_sums`` before
    they normalise: with a sum over the ranks that hold the other bands,
    the rows of the whole stack. The gradient is the plain twin's
    (:class:`_FusedBand`)."""
    return _FusedBand.apply(x.contiguous(), _stack_spec(encoder), r0, r1, reduce_sums,
                            *_stack_params(encoder))


def encoder_stack_ref(encoder, x):
    """Plain version of one stack through the fused-layer math (E[y^2] -
    E[y]^2 GroupNorm from channel sums)."""
    return _stacks_ref(x, _stack_params(encoder), (_stack_spec(encoder),))


def encoder_stack_fused(encoder, x):
    """``Encoder`` forward with every GN -> SiLU -> conv layer on K1 (on
    CUDA tensors; their plain versions on the CPU). x (B,H,W,3) NHWC ->
    (B,H,W,hidden)."""
    return _FusedStacks.apply(x.contiguous(), (_stack_spec(encoder),), *_stack_params(encoder))


def encoder_stack_fused_packed(enc_pix, enc_sem, x):
    """Both image-encoder stacks into one packed (B,H,W,2*hidden) buffer,
    pixel stack first (the reference's torch.cat order), the last layer of
    each writing its half."""
    specs = (_stack_spec(enc_pix), _stack_spec(enc_sem))
    return _FusedStacks.apply(x.contiguous(), specs, *_stack_params(enc_pix),
                              *_stack_params(enc_sem))
