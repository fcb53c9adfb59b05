"""Fused encoder layers: kernel K1 and the torch glue around it.

Counterpart of ``naf_tpu/kernels/encoder_fused.py``. The NAF image encoder is
a chain of [GroupNorm -> SiLU -> reflect conv] layers. Each layer runs as ONE
kernel (``csrc/encoder_fused.cu``):

    y = conv_k(silu(x * scale + shift)) + bias      (+ f32 channel sums of y)

where scale/shift fold the GroupNorm normalisation and affine into a
per-sample, per-channel multiply-add, finalised from the previous layer's
channel sums by :func:`_gn_affine`, so GroupNorm never takes a pass over the
activations. The stem conv and the first channel sums stay torch glue.

:func:`encoder_stack_fused_packed` runs the pixel (k=1) and semantic (k=3)
stacks and has each stack's last layer write its half of one
(B, H, W, 2*hidden) buffer, so the pix|sem concat never happens.

Every function has a plain PyTorch version beside it (``*_ref``). The
wrappers take it for CPU tensors only; for CUDA tensors they launch the
kernel or raise. Their backward recomputes through the plain version, as
the JAX package's custom VJPs do.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from naf_torch.kernels import _build

__all__ = [
    "gn_silu_conv_fused",
    "gn_silu_conv_ref",
    "encoder_stack_fused",
    "encoder_stack_fused_packed",
    "encoder_stack_ref",
]


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


def gn_silu_conv_ref(x, scale, shift, weight, bias):
    """Plain version of K1. x (B,H,W,C); scale/shift (B,C) or (C,) f32;
    weight (F,C,k,k); bias (F,). Returns (y (B,H,W,F) in x's dtype,
    psums (B,2,F) f32 of the f32 y)."""
    z = x.float() * scale.float()[..., None, None, :] + shift.float()[..., None, None, :]
    z = F.silu(z).to(x.dtype)  # the activated input rounds to the io dtype
    y = _conv_nhwc(z, weight, bias)
    return y.to(x.dtype), _channel_sums(y)


@functools.cache
def _lib():
    lib = _build.load("encoder_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.naf_gn_silu_conv_tiles.argtypes = [i32, i32]
    lib.naf_gn_silu_conv_tiles.restype = i32
    lib.naf_gn_silu_conv.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
    lib.naf_gn_silu_conv.restype = i32
    return lib


def _launch(x, scale, shift, weight, bias, out=None, out_off: int = 0):
    """Launch K1 on CUDA tensors. With ``out`` (B,H,W,total), y is written at
    channels [out_off, out_off + F) of it. Returns (out, psums)."""
    if x.device.type != "cuda":
        raise ValueError(f"K1 launches on CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("K1 takes a contiguous NHWC tensor")
    b, h, w, c = x.shape
    f, ci, k, k2 = weight.shape
    if ci != c or k != k2 or k not in (1, 3):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x {tuple(x.shape)}")
    if c % 16 or f % 64:
        raise ValueError(f"K1 needs C % 16 == 0 and F % 64 == 0, got C={c}, F={f}")
    if k == 3 and min(h, w) < 2:
        raise ValueError("reflect padding needs H, W >= 2")
    for t in (scale, shift, weight, bias):
        if t.device != x.device:
            raise ValueError("all K1 inputs must be on one device")
    if bias.shape != (f,):
        raise ValueError(f"bias {tuple(bias.shape)} must be ({f},)")
    if scale.shape not in ((b, c), (c,)) or shift.shape not in ((b, c), (c,)):
        raise ValueError(f"scale/shift must be ({b}, {c}) or ({c},)")
    w_taps = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(k * k, c, f).contiguous()
    sc = scale.float().expand(b, c).contiguous()
    sh = shift.float().expand(b, c).contiguous()
    b32 = bias.float().contiguous()
    if out is None:
        out = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    elif (out.ndim != 4 or out.shape[:3] != x.shape[:3] or out.dtype != x.dtype
          or not out.is_contiguous() or out.shape[3] % 8 or out_off % 8
          or out_off + f > out.shape[3]):
        raise ValueError("packed output buffer does not fit this layer")
    lib = _lib()
    part = torch.empty((b, lib.naf_gn_silu_conv_tiles(h, w), 2, f), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = lib.naf_gn_silu_conv(
            x.data_ptr(), sc.data_ptr(), sh.data_ptr(), w_taps.data_ptr(), b32.data_ptr(),
            out.data_ptr(), part.data_ptr(), b, h, w, c, f, k, out.shape[3], out_off,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"encoder_fused kernel launch failed: cudaError {err}")
    gn_silu_conv_fused.launches += 1
    return out, part.sum(dim=1)


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


def _run_stack(x, params, spec, layer, out=None, out_off=0):
    """Stem + 2*num_layers fused layers; ``layer`` is K1's launch or the
    plain version. The last layer writes into ``out`` when given."""
    num_layers, num_groups, eps = spec
    y = _stem_conv(x, params[0], params[1])
    ps = _channel_sums(y)
    hw = x.shape[1] * x.shape[2]
    n_lay = 2 * num_layers
    for li in range(n_lay):
        gamma, beta, weight, bias = params[2 + 4 * li : 6 + 4 * li]
        scale, shift = _gn_affine(ps, gamma, beta, hw, num_groups, eps)
        if li == n_lay - 1 and out is not None:
            y, ps = layer(y, scale, shift, weight, bias, out, out_off)
        else:
            y, ps = layer(y, scale, shift, weight, bias)
    return y


def _ref_layer(x, scale, shift, weight, bias, out=None, out_off=0):
    return gn_silu_conv_ref(x, scale, shift, weight, bias)


def _split(params, specs):
    """Per-stack slices of the flat parameter list."""
    out, i = [], 0
    for spec in specs:
        n = 2 + 8 * spec[0]
        out.append(params[i : i + n])
        i += n
    return out


def _stacks_ref(x, params, specs):
    outs = [_run_stack(x, p, spec, _ref_layer)
            for p, spec in zip(_split(params, specs), specs)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


class _FusedStacks(torch.autograd.Function):
    """One or more encoder stacks on K1; with several, their outputs are
    packed side by side in one buffer by the last layer of each."""

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
            _run_stack(x, p, spec, _launch, out, off)
            off += hd
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        with torch.enable_grad():
            out = _stacks_ref(inputs[0], inputs[1:], ctx.specs)
        grads = _grads((out,), (g,), inputs)
        return (grads[0], None, *grads[1:])


def encoder_stack_ref(encoder, x):
    """Plain version of one stack through the fused-layer math (E[y^2] -
    E[y]^2 GroupNorm from channel sums)."""
    return _stacks_ref(x, _stack_params(encoder), (_stack_spec(encoder),))


def encoder_stack_fused(encoder, x):
    """``Encoder`` forward with every GN -> SiLU -> conv layer on K1.
    x (B,H,W,3) NHWC -> (B,H,W,hidden)."""
    if x.device.type == "cpu":
        return encoder_stack_ref(encoder, x)
    return _FusedStacks.apply(x.contiguous(), (_stack_spec(encoder),),
                              *_stack_params(encoder))


def encoder_stack_fused_packed(enc_pix, enc_sem, x):
    """Both image-encoder stacks into one packed (B,H,W,2*hidden) buffer,
    pixel stack first (the reference's torch.cat order)."""
    specs = (_stack_spec(enc_pix), _stack_spec(enc_sem))
    params = _stack_params(enc_pix) + _stack_params(enc_sem)
    if x.device.type == "cpu":
        return _stacks_ref(x, params, specs)
    return _FusedStacks.apply(x.contiguous(), specs, *params)
