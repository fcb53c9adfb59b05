"""The encoder's stem kernel's module side (``naf_torch.kernels.encoder_fused``:
``stem_conv_fused``, ``stem_conv_ref``, ``stem_tile_sums_ref``) on the CPU:
the CPU route is the plain stem bit for bit; the plain per-tile partials on
``tile_plan``'s tiles sum to the channel sums; a numpy emulation of the
kernel's order of work (the reflected halo of each 8 x 16 tile, the weights'
shared-memory layout as each thread reads it, slices of 64 channels, a
thread per (8-channel group, tile column, half of the tile's rows), the two
roundings, the partials' fixed order: the columns of a half of the rows,
half by half) against the plain stem; the shape rules; which runner
takes the kernel: ``_FusedStacks``' forward takes it, the plain twin
(``_stacks_ref``, which the backward differentiates) never does, and a
chain that autograd records is refused on the kernels; and the
one encoder chain (``_chain``) across its routes: a band that is the whole
image is the whole stack, and the banded encoder's rows from its sweeps'
statistics are the spatial band's whose sums are all-reduced over the
bands (threads here). The kernel itself runs on the card:
``tests/test_torch_card_stem.py``."""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from naf_torch.kernels import encoder_fused as ef
from naf_torch.kernels.encoder_banded import encoder_stack_banded_rows, encoder_stack_stats
from naf_torch.nn import Encoder

torch.set_num_threads(1)


def _inputs(b, h, w, f, k, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, 3).astype(np.float32)).to(dtype)
    weight = torch.from_numpy((rng.randn(f, 3, k, k) * (3 * k * k) ** -0.5)
                              .astype(np.float32)).to(dtype)
    bias = torch.from_numpy((rng.randn(f) * 0.1).astype(np.float32)).to(dtype)
    return x, weight, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3])
def test_cpu_route_is_the_plain_stem(k, dtype):
    x, weight, bias = _inputs(2, 20, 37, 128, k, dtype)
    y, ps = ef.stem_conv_fused(x, weight, bias)
    want_y = ef._stem_conv(x, weight, bias)
    assert y.dtype == dtype and y.shape == (2, 20, 37, 128) and y.is_contiguous()
    assert torch.equal(y, want_y)
    assert ps.dtype == torch.float32 and torch.equal(ps, ef._channel_sums(want_y))
    ref_y, ref_ps = ef.stem_conv_ref(x, weight, bias)
    assert torch.equal(y, ref_y) and torch.equal(ps, ref_ps)


@pytest.mark.parametrize("b,h,w,f", [(2, 20, 37, 128), (1, 8, 16, 8), (1, 9, 17, 24),
                                     (3, 33, 5, 48)])
def test_tile_sums_sum_to_the_channel_sums(b, h, w, f):
    rng = np.random.RandomState(1)
    y = torch.from_numpy(rng.randn(b, h, w, f).astype(np.float32)).to(torch.bfloat16)
    tiles_h, tiles_w, _, _ = ef.tile_plan(h, w, 3)
    part = ef.stem_tile_sums_ref(y)
    assert part.dtype == torch.float32 and part.shape == (b, tiles_h * tiles_w, 2, f)
    torch.testing.assert_close(part.sum(dim=1), ef._channel_sums(y), rtol=1e-5, atol=1e-4)
    # the last tile, row-major: rows [8 (th - 1), h), columns [16 (tw - 1), w)
    last = y[:, 8 * (tiles_h - 1):, 16 * (tiles_w - 1):].float()
    torch.testing.assert_close(part[:, -1], torch.stack(
        [last.sum(dim=(1, 2)), (last * last).sum(dim=(1, 2))], dim=1))
    # float64 stays float64 (the card check's oracle)
    assert ef.stem_tile_sums_ref(y.double()).dtype == torch.float64


def _round_io(a, dtype):
    return torch.from_numpy(a).to(dtype).float().numpy()


def _emulate_kernel(x, weight, bias):
    """stem_conv_kernel's order of work in numpy f32 (products and sums
    rounded separately, where the kernel fuses them): (y, part)."""
    b, h, w, _ = x.shape
    f, _, k, _ = weight.shape
    if f % 8:  # the wrapper pads F to a multiple of 8 and slices it back
        pf = -f % 8
        y, part = _emulate_kernel(x, torch.nn.functional.pad(weight, (0, 0, 0, 0, 0, 0, 0, pf)),
                                  torch.nn.functional.pad(bias, (0, pf)))
        return y[..., :f], part[..., :f]
    r_taps, th, tw = 3 * k * k, 8, 16
    tiles_h, tiles_w, rows, cols = ef.tile_plan(h, w, k)
    xs = x.float().numpy()
    wt = weight.contiguous().float().numpy().reshape(f, r_taps)
    bs_all = bias.to(x.dtype).float().numpy()
    y = np.zeros((b, h, w, f), np.float32)
    part = np.zeros((b, tiles_h * tiles_w, 2, f), np.float32)
    sf = 64
    groups = sf // 8
    rows_a = 4  # tile rows a thread
    for f0 in range(0, f, sf):  # blockIdx.y
        nf = min(sf, f - f0)
        ws = np.zeros(r_taps * sf, np.float32)
        for e in range(r_taps * sf):
            ff, r = e % sf, e // sf
            ws[(r * 2 + (ff % 8) // 4) * (sf // 2) + (ff // 8) * 4 + ff % 4] = (
                wt[f0 + ff, r] if ff < nf else 0.0)
        bs = np.array([bs_all[f0 + e] if e < nf else 0.0 for e in range(sf)], np.float32)
        for item in range(b * tiles_h * tiles_w):
            bi, tile = divmod(item, tiles_h * tiles_w)
            ty, tx = divmod(tile, tiles_w)
            oy, ox = ty * th, tx * tw
            halo = xs[bi][rows[ty].numpy()][:, cols[tx].numpy()]  # (HH, HW, 3)
            acc = np.zeros((tw, groups, th, 8), np.float32)  # [col][g][row][j]; rows in 4s
            for c in range(3):
                for dx in range(k):
                    zc = np.stack([halo[:, col + dx, c] for col in range(tw)])  # (col, HH)
                    for dy in range(k):
                        base = ((c * k + dy) * k + dx) * 2 * (sf // 2)
                        idx = base + np.arange(groups) * 4
                        wv = np.concatenate([ws[idx[:, None] + np.arange(4)],
                                             ws[idx[:, None] + sf // 2 + np.arange(4)]], axis=1)
                        acc += zc[:, None, dy:dy + th, None] * wv[None, :, None, :]
            v = _round_io(_round_io(acc, x.dtype) + bs.reshape(groups, 8)[None, :, None, :],
                          x.dtype)
            red = np.zeros((th // rows_a, tw, 2, sf), np.float32)  # [half][col]
            for half in range(th // rows_a):
                row0 = half * rows_a
                rows_in = [i for i in range(row0, row0 + rows_a) if oy + i < h]
                for col in range(tw):
                    for g in range(groups):
                        if 8 * g >= nf or ox + col >= w or not rows_in:
                            continue
                        vv = v[col, g, rows_in]  # (rows, 8)
                        y[bi, oy + rows_in[0]: oy + rows_in[-1] + 1, ox + col,
                          f0 + 8 * g: f0 + 8 * g + 8] = vv
                        s = q = np.zeros(8, np.float32)
                        for row in vv:
                            s, q = s + row, q + row * row
                        red[half, col, 0, 8 * g: 8 * g + 8] = s
                        red[half, col, 1, 8 * g: 8 * g + 8] = q
            # the 16 columns of the first half, then of the second, in order
            t = np.zeros((2, sf), np.float32)
            for half in range(th // rows_a):
                for col in range(tw):
                    t = t + red[half, col]
            part[bi, tile, :, f0: f0 + nf] = t[:, :nf]
    return torch.from_numpy(y).to(x.dtype), torch.from_numpy(part)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,f", [(1, 128), (3, 128), (3, 20), (1, 200)])
def test_emulated_kernel_matches_the_plain_stem(k, f, dtype):
    """F 20 takes the wrapper's padding (5 of a slice's 8 groups idle), F
    200 four slices (the last of 8 channels); 20 x 37 is ragged in both
    axes of the tile."""
    x, weight, bias = _inputs(2, 20, 37, f, k, dtype, seed=2)
    y, part = _emulate_kernel(x, weight, bias)
    want_y, _ = ef.stem_conv_ref(x, weight, bias)
    conv = ef._conv_nhwc(x, weight)
    if dtype == torch.bfloat16:
        # one rounding step at each rounding point: the conv's, then y's
        def step(v):
            return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)
        bar = step(conv) + step(want_y.float())
        assert bool(((y.float() - want_y.float()).abs() <= bar).all())
        assert float((y == want_y).double().mean()) > 0.99
    else:
        torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    tiles = ef.stem_tile_sums_ref(y)
    mags = ef.stem_tile_sums_ref(y.abs())
    assert bool(((part - tiles).abs() <= 1e-5 * mags + 1e-30).all())
    torch.testing.assert_close(part.sum(dim=1), ef._channel_sums(y), rtol=1e-5, atol=1e-3)


SHAPE_ERRORS = {
    "four channels": (((1, 8, 8, 4), (16, 4, 3, 3), (16,)), "3 image channels"),
    "k 5": (((1, 8, 8, 3), (16, 3, 5, 5), (16,)), "k in (1, 3)"),
    "k 2": (((1, 8, 8, 3), (16, 3, 2, 2), (16,)), "k in (1, 3)"),
    "non-square k": (((1, 8, 8, 3), (16, 3, 3, 1), (16,)), "k in (1, 3)"),
    "one row at k 3": (((1, 1, 8, 3), (16, 3, 3, 3), (16,)), "H, W >= 2"),
    "one column at k 3": (((1, 8, 1, 3), (16, 3, 3, 3), (16,)), "H, W >= 2"),
    "bias": (((1, 8, 8, 3), (16, 3, 1, 1), (8,)), "must be (16,)"),
    "NCHW-less": (((8, 8, 3), (16, 3, 1, 1), (16,)), "contiguous NHWC"),
}


@pytest.mark.parametrize("case", list(SHAPE_ERRORS))
def test_shape_errors(case):
    args, words = SHAPE_ERRORS[case]
    err = ef._stem_shape_error(*args)
    assert err is not None and words in err


@pytest.mark.parametrize("shape,k", [((2, 20, 37, 3), 3), ((1, 1, 1, 3), 1), ((1, 2, 2, 3), 3)])
def test_shapes_the_kernel_takes(shape, k):
    assert ef._stem_shape_error(shape, (128, 3, k, k), (128,)) is None
    err = ef._stem_shape_error(shape, (128, 3, k, k), (128,), contiguous=False)
    assert err is not None and "contiguous" in err


def test_off_the_cpu_the_wrapper_launches_or_raises():
    """On a device that is neither the CPU nor CUDA (``meta``) the wrapper
    raises at the launch's device check, and under autograd before it."""
    x, weight, bias = (t.to("meta") for t in _inputs(1, 8, 16, 8, 3, torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ef.stem_conv_fused(x, weight, bias)
    with pytest.raises(NotImplementedError, match="inference-only"):
        ef.stem_conv_fused(x, weight.requires_grad_(), bias)


def _stacks(hidden=32, layers=1):
    torch.manual_seed(3)
    pix = Encoder(hidden, kernel_size=1, ks_res=1, num_layers=layers)
    sem = Encoder(hidden, kernel_size=3, ks_res=3, num_layers=layers)
    specs = (ef._stack_spec(pix), ef._stack_spec(sem))
    return ef._stack_params(pix) + ef._stack_params(sem), specs


def test_fused_stacks_take_the_kernel_and_the_twin_never_does(monkeypatch):
    """``_FusedStacks`` on CPU tensors with the route made to answer "the
    kernels" and the launches replaced by their plain versions: its forward
    calls the stem kernel's launch once a stack and K1's once a layer; its
    backward differentiates ``_stacks_ref``, which calls neither."""
    stems, layers = [], []

    def stem(x, weight, bias):
        stems.append(weight.shape[-1])
        return ef.stem_conv_ref(x, weight, bias)

    def layer(x, scale, shift, weight, bias, out=None, out_off=0):
        layers.append(weight.shape[-1])
        y, ps = ef.gn_silu_conv_ref(x, scale, shift, weight, bias)
        if out is None:
            return y, ps
        out[..., out_off: out_off + y.shape[-1]] = y
        return out, ps

    monkeypatch.setattr(ef, "_launch_stem", stem)
    monkeypatch.setattr(ef, "_launch", layer)
    monkeypatch.setattr(ef, "_takes_kernels", lambda x, twin: not twin)
    params, specs = _stacks()
    x = torch.randn(1, 12, 20, 3, requires_grad=True)
    got = ef._FusedStacks.apply(x, specs, *params)
    assert stems == [1, 3] and layers == [1, 1, 3, 3]
    want = ef._stacks_ref(x, params, specs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.square().sum().backward()
    assert stems == [1, 3] and layers == [1, 1, 3, 3]  # the twin launched nothing
    grads = [p.grad.clone() for p in params]
    for p in params:
        p.grad = None
    want.square().sum().backward()
    for g, p in zip(grads, params):
        torch.testing.assert_close(g, p.grad)


def test_the_twin_never_reaches_the_kernel(monkeypatch):
    """``_stacks_ref`` and ``_twin_grads`` (the backward's recompute, bf16
    packing included) run with both launches made to raise."""
    def boom(*args, **kwargs):
        raise AssertionError("the plain twin reached a kernel launch")

    for name in ("_launch_stem", "_launch_stem_tiles", "_launch"):
        monkeypatch.setattr(ef, name, boom)
    params, specs = _stacks()
    x = torch.randn(1, 12, 20, 3)
    out = ef._stacks_ref(x, params, specs)
    saved = [x.bfloat16()] + [p.detach().bfloat16() for p in params]
    needs = [True] * len(saved)
    grads = ef._twin_grads(saved, needs, specs, torch.ones(out.shape, dtype=torch.bfloat16))
    assert len(grads) == len(saved) and all(g is not None for g in grads)


def test_the_route_is_the_plain_pair_on_the_cpu(monkeypatch):
    """CPU tensors take the plain pair with or without autograd: the
    packed stacks launch nothing there."""
    def boom(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel launch")

    for name in ("_launch_stem", "_launch_stem_tiles", "_launch"):
        monkeypatch.setattr(ef, name, boom)
    params, specs = _stacks()
    x = torch.randn(1, 12, 20, 3)
    assert not ef._takes_kernels(x, False)
    with torch.no_grad():
        got = ef._FusedStacks.apply(x, specs, *params)
    torch.testing.assert_close(got, ef._stacks_ref(x, params, specs), rtol=0, atol=0)


def test_the_kernels_refuse_a_chain_that_autograd_records(monkeypatch):
    """With the route made to answer "the kernels" and the launches replaced
    by their plain versions: the streamed encoder's functions, which call
    the chain directly, run under no_grad, each band's stem on the tile
    launch (its sums come from the statistics); under autograd they raise.
    The spatial band's Function, whose backward is the twin's, runs."""
    stems, tiles = [], []

    def stem(x, weight, bias):
        stems.append(weight.shape[-1])
        return ef.stem_conv_ref(x, weight, bias)

    def stem_tiles(x, weight, bias):
        tiles.append(weight.shape[-1])
        y, _ = ef.stem_conv_ref(x, weight, bias)
        return y, ef.stem_tile_sums_ref(y)

    def layer(x, scale, shift, weight, bias):
        return ef.gn_silu_conv_ref(x, scale, shift, weight, bias)

    monkeypatch.setattr(ef, "_launch_stem", stem)
    monkeypatch.setattr(ef, "_launch_stem_tiles", stem_tiles)
    monkeypatch.setattr(ef, "_launch", layer)
    monkeypatch.setattr(ef, "_takes_kernels", lambda x, twin: not twin)
    torch.manual_seed(3)
    enc = Encoder(16, kernel_size=3, ks_res=3, num_layers=2)
    x = torch.randn(1, 24, 20, 3)
    with torch.no_grad():
        stats = encoder_stack_stats(enc, x, band_rows=8)
        encoder_stack_banded_rows(enc, x, 8, 8, stats)
    assert stems == [] and tiles == [3] * (4 * 3 + 1)  # 4 depths x 3 bands, then the rows
    with pytest.raises(NotImplementedError, match="inference-only"):
        encoder_stack_banded_rows(enc, x, 8, 8, stats)
    with pytest.raises(NotImplementedError, match="inference-only"):
        encoder_stack_stats(enc, x, band_rows=8)
    ef.encoder_stack_band(enc, x, 0, 24, lambda t: t).square().sum().backward()
    assert all(p.grad is not None for p in enc.parameters())


@pytest.mark.parametrize("k", [1, 3])
def test_a_band_of_the_whole_image_is_the_whole_stack(k):
    """The chain over rows [0, H) with the identity reduction (the spatial
    band's route on one rank) equals the whole stack's plain twin, f32."""
    torch.manual_seed(k)
    enc = Encoder(32, kernel_size=k, ks_res=k, num_layers=2)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.05 * torch.randn_like(p))
        params, spec = ef._stack_params(enc), ef._stack_spec(enc)
        x = torch.randn(2, 28, 20, 3)
        got = ef._chain(x, params, spec, (0, 28), stats=ef._band_stats(lambda t: t))
        want = ef._stacks_ref(x, params, (spec,))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(ef.encoder_stack_band(enc, x, 0, 28, lambda t: t), want,
                                   rtol=0, atol=0)


class _ThreadSum:
    """A sum over n threads, each passing its part: an all-reduce."""

    def __init__(self, n: int):
        self.parts, self.barrier = [None] * n, threading.Barrier(n, timeout=60)

    def __call__(self, j: int, t):
        self.parts[j] = t
        self.barrier.wait()
        total = sum(self.parts)
        self.barrier.wait()  # every part read before the next layer's replaces it
        return total


@pytest.mark.parametrize("k", [1, 3])
def test_streamed_rows_are_the_spatial_band_summed_over_every_band(k):
    """``encoder_stack_banded_rows`` from ``encoder_stack_stats`` (the
    streamed encoder: statistics from banded sweeps) equals the spatial
    band's route (``encoder_stack_band``) over the same rows when each
    layer's band sums are summed over all bands, each band on a thread of
    its own, f32."""
    torch.manual_seed(10 + k)
    enc = Encoder(16, kernel_size=k, ks_res=k, num_layers=2)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.05 * torch.randn_like(p))
    x = torch.randn(2, 32, 24, 3)
    bands = [(0, 8), (8, 20), (20, 32)]
    reduce = _ThreadSum(len(bands))

    def band(j):
        r0, r1 = bands[j]
        with torch.no_grad():
            return ef.encoder_stack_band(enc, x, r0, r1, lambda t: reduce(j, t))

    with ThreadPoolExecutor(len(bands)) as pool:
        got = [f.result(timeout=120) for f in [pool.submit(band, j) for j in range(len(bands))]]
    with torch.no_grad():
        stats = encoder_stack_stats(enc, x, band_rows=8)
        for (r0, r1), g in zip(bands, got):
            torch.testing.assert_close(g, encoder_stack_banded_rows(enc, x, r0, r1 - r0, stats))
