"""The encoder's stem kernel (``encoder_fused.stem_conv_fused``, in
``csrc/encoder_fused.cu``) on the card against its plain version
(``_stem_conv`` + ``_channel_sums``, cuDNN with TF32 off), through
``chip_smoke.stem_check``, the check phase 24 makes: k 1 and 3, bf16 and f32,
batch 1 and 2, at 448^2, a ragged 452 x 300 and 2048^2, F 20 (the wrapper's
zero padding), 48, 128, 200 (four 64-channel slices, the last of 8) and
256. bf16 y lies within
one rounding step at each of its two rounding points and equals the plain y
on >= 99.9% of its elements; f32 y lies within (3k^2 + 1) 2^-24 of the sum
of its terms' magnitudes of a float64 conv; the sums and per-tile partials
within 1e-5 of the sums of magnitudes of the kernel's own y. Also: both
stacks (``encoder_stack_fused_packed``) against their plain twin at
``test_torch_card_encoder.py``'s bars, two launches a forward, the 2048^2
encoder forward's peak above its start, and the banded routes (a spatial
band, the streamed encoder's sweeps and rows) on the stem kernel, one
launch a stack and band.

Every test here needs the card (marker ``cuda``) and skips without one. The
file imports no JAX:

    python -m pytest -m cuda tests/test_torch_card_stem.py -q -s
"""

import pytest
import torch

from naf_torch.api import NAFUpsampler, load_naf_params
from naf_torch.kernels import encoder_fused as ef
from naf_torch.kernels import launch_counts
from naf_torch.nn import Encoder

# (batch, H, W, F)
SHAPES = [(1, 448, 448, 128), (2, 448, 448, 128), (2, 452, 300, 48), (1, 452, 300, 256),
          (2, 24, 40, 20), (1, 24, 40, 200), (1, 2048, 2048, 128)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 24 holds the stem kernel there")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, h, w, f, k, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, 3, generator=gen, device=dev).to(dtype)
    weight = (torch.randn(f, 3, k, k, generator=gen, device=dev) * (3 * k * k) ** -0.5).to(dtype)
    bias = (torch.randn(f, generator=gen, device=dev) * 0.1).to(dtype)
    return x, weight, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("b,h,w,f", SHAPES)
def test_stem_kernel_against_the_plain_stem(cuda_device, b, h, w, f, k, dtype):
    from chip_smoke import stem_check

    x, weight, bias = _inputs(cuda_device, b, h, w, f, k, dtype)
    err, same, sums = stem_check(f"{b}x{h}x{w} F{f} k{k} {dtype}", x, weight, bias)
    print(f"stem {b} x {h} x {w}, F {f}, k {k}, {dtype}: max abs err {err:.3e}, "
          f"{same:.5%} equal, sums {sums:.3f} of their bar")
    # the public wrapper: the same y, and the partials summed
    y, ps = ef.stem_conv_fused(x, weight, bias)
    y2, part = ef._launch_stem_tiles(x, weight, bias)
    assert torch.equal(y, y2) and torch.equal(ps, part.sum(dim=1))
    assert y.is_contiguous() and y.shape == (b, h, w, f) and y.dtype == dtype


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, weight, bias = _inputs(cuda_device, 1, 16, 16, 64, 3, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        ef.stem_conv_fused(x.transpose(1, 2), weight, bias)
    with pytest.raises(ValueError, match="3 image channels"):
        ef.stem_conv_fused(torch.cat([x, x[..., :1]], dim=-1), weight, bias)
    with pytest.raises(TypeError):
        ef.stem_conv_fused(x.half(), weight, bias)
    with pytest.raises(NotImplementedError):
        ef.stem_conv_fused(x, weight.requires_grad_(), bias)


def _stacks(dev, dtype, hidden=128):
    torch.manual_seed(0)
    pix = Encoder(hidden, kernel_size=1, ks_res=1, num_layers=2)
    sem = Encoder(hidden, kernel_size=3, ks_res=3, num_layers=2)
    with torch.no_grad():  # GroupNorm affines away from 1 and 0
        for p in list(pix.parameters()) + list(sem.parameters()):
            p.add_(0.05 * torch.randn_like(p))
    return pix.to(dev, dtype), sem.to(dev, dtype)


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w", [(1, 448, 448), (2, 452, 300)])
def test_stacks_against_their_plain_twin(cuda_device, b, h, w, dtype):
    """Both stacks on the stem kernel and K1 against ``_stacks_ref`` on f32
    copies: bf16 cosine > 0.9995, f32 atol = rtol = 2e-4; two stem and
    eight K1 launches a forward."""
    pix, sem = _stacks(cuda_device, dtype)
    x = torch.randn(b, h, w, 3, device=cuda_device).to(dtype)
    before = launch_counts()
    with torch.no_grad():
        got = ef.encoder_stack_fused_packed(pix, sem, x)
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["stem"] - before["stem"], after["k1"] - before["k1"]) == (2, 8)
    specs = (ef._stack_spec(pix), ef._stack_spec(sem))
    params = [p.float() for p in ef._stack_params(pix) + ef._stack_params(sem)]
    with torch.no_grad():
        want = ef._stacks_ref(x.float(), params, specs)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    else:
        assert _cos(got.float(), want) > 0.9995


@pytest.mark.cuda
def test_two_stem_launches_an_upsampler_call(cuda_device):
    ups = NAFUpsampler(model=load_naf_params(dtype=torch.bfloat16))
    image = torch.randn(1, 3, 448, 448, device=cuda_device).to(torch.bfloat16)
    feats = torch.randn(1, 384, 28, 28, device=cuda_device).to(torch.bfloat16)
    before = launch_counts()
    out = ups(image, feats, (448, 448))
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["stem"] - before["stem"], after["k1"] - before["k1"]) == (2, 8)
    assert out.shape == (1, 384, 448, 448) and bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_encoder_peak_at_2048(cuda_device):
    """The 2048^2 encoder forward (both stacks, bf16, hidden 128) peaks at
    most 4,400 MiB above its start: the packed output (2 GiB) and a layer's
    input and output (1 GiB each), with no f32 copy of a stem's output."""
    pix, sem = _stacks(cuda_device, torch.bfloat16)
    x = torch.randn(1, 2048, 2048, 3, device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        ef.encoder_stack_fused_packed(pix, sem, x)  # the weights' packing index, once
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = ef.encoder_stack_fused_packed(pix, sem, x)
        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"2048^2 encoder forward: peak {peak:.1f} MiB above its start "
          f"({torch.cuda.get_device_name(0)})")
    assert out.shape == (1, 2048, 2048, 256)
    assert peak <= 4400


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_banded_forwards_take_the_stem_kernel(cuda_device, dtype):
    """The banded routes launch the stem kernel as the whole stack does:
    the spatial band's forward (``encoder_stack_band``, here one rank's
    identity reduction) once a stack and band, each band against the plain
    twin over the same rows at the whole stacks' bars; the streamed
    encoder's sweeps and rows (``encoder_stack_stats`` and
    ``encoder_stack_banded_rows``) once a stack, depth and band, and once a
    stack and band."""
    from naf_torch.kernels.encoder_banded import encoder_stack_banded_rows, encoder_stack_stats

    pix, sem = _stacks(cuda_device, dtype)
    x = torch.randn(1, 448, 448, 3, device=cuda_device).to(dtype)
    bands = [(0, 112), (112, 336), (336, 448)]
    before = launch_counts()
    with torch.no_grad():
        got = [[ef.encoder_stack_band(st, x, r0, r1, lambda t: t) for st in (pix, sem)]
               for r0, r1 in bands]
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["stem"] - before["stem"], after["k1"] - before["k1"]) == (6, 24)
    for (r0, r1), outs in zip(bands, got):
        for st, o in zip((pix, sem), outs):
            params = [p.float() for p in ef._stack_params(st)]
            with torch.no_grad():
                want = ef._chain(x.float(), params, ef._stack_spec(st), (r0, r1),
                                 stats=ef._band_stats(lambda t: t), twin=True)
            assert o.dtype == dtype and o.shape == want.shape
            if dtype == torch.float32:
                torch.testing.assert_close(o, want, atol=2e-4, rtol=2e-4)
            else:
                assert _cos(o.float(), want) > 0.9995
    before = launch_counts()
    with torch.no_grad():
        for st in (pix, sem):
            stats = encoder_stack_stats(st, x, band_rows=112)
            for r0 in range(0, 448, 112):
                encoder_stack_banded_rows(st, x, r0, 112, stats)
    torch.cuda.synchronize()
    after = launch_counts()
    # per stack: 4 depths x 4 bands in the sweeps, then 4 bands of rows
    assert (after["stem"] - before["stem"], after["k1"] - before["k1"]) == (40, 2 * (24 + 16))
