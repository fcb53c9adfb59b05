"""The keys kernel (``csrc/rope_keys.cu``) on the card against the f32 plain
version (``RoPE.pooled`` and ``RoPE.tables`` on f32 tensors, TF32 off): the
benchmark cells' shapes (448^2 with 28^2 features, 448^2 -> 2048^2 and
2048^2 with 128^2), DAVIS's 480 x 854 with 30 x 53, a batch of 2, the input
guard's 4:1 pool-down (windows wider than one chunk), one key from a whole
grid, NAF(dim=96)'s heads (d 24: 4-channel runs), 2-channel runs (d 12) and
the f32 route. bf16 keys lie within one rounding of the f32 keys:
|got - ref| <= 2^-8 |ref| + 1e-5 max|ref|, since the kernel sums in f32 and
rounds once; f32 keys within 1e-4 relative; the tables equal RoPE.tables to
1e-6. Each call is one launch, checked by ``torch.cuda.synchronize()``. The
kernel's bandwidth at 2048^2 is printed beside the plain version's time, and
one ``NAFUpsampler`` call launches the kernel once.

Every test here needs the card (marker ``cuda``) and skips without one. The
file imports no JAX:

    python -m pytest -m cuda tests/test_torch_card_rope_keys.py -q -s
"""

import pytest
import torch

from naf_torch.api import NAFUpsampler, load_naf_params
from naf_torch.kernels import launch_counts
from naf_torch.kernels.rope_keys import rope_keys, rope_keys_ref
from naf_torch.nn.rope import RoPE

# (enc hi, wi, up oh, ow, down hk, wk, batch, C, RoPE heads, dtype)
SHAPES = {
    "448": (448, 448, 448, 448, 28, 28, 1, 256, 4, torch.bfloat16),
    "448->2048": (448, 448, 2048, 2048, 128, 128, 1, 256, 4, torch.bfloat16),
    "2048": (2048, 2048, 2048, 2048, 128, 128, 1, 256, 4, torch.bfloat16),
    "davis": (480, 854, 480, 854, 30, 53, 1, 256, 4, torch.bfloat16),
    "batch2": (224, 320, 448, 640, 28, 40, 2, 256, 4, torch.bfloat16),
    "guard": (1792, 1792, 448, 448, 28, 28, 1, 256, 4, torch.bfloat16),
    "one-key": (96, 80, 96, 80, 1, 1, 1, 256, 4, torch.bfloat16),
    "c96": (448, 448, 448, 448, 28, 28, 1, 96, 4, torch.bfloat16),
    "c24": (60, 52, 120, 104, 9, 7, 1, 24, 2, torch.bfloat16),
    "f32": (224, 224, 448, 448, 28, 28, 1, 256, 4, torch.float32),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, name, seed=0):
    hi, wi, oh, ow, hk, wk, b, c, heads, dt = SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc = torch.randn(b, hi, wi, c, generator=gen, device=dev).to(dt)
    return RoPE(c, heads).to(dev), enc, (oh, ow), (hk, wk)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_keys_kernel_against_the_f32_plain_version(cuda_device, name):
    rope, enc, up, down = _case(cuda_device, name)
    launches = launch_counts()["keys"]
    with torch.no_grad():
        keys, rows_tab, cols_tab = rope_keys(rope, enc, up, down)
    torch.cuda.synchronize()
    assert launch_counts()["keys"] == launches + 1
    ref_keys, ref_rows, ref_cols = rope_keys_ref(rope, enc.float(), up, down)
    assert keys.dtype == enc.dtype and keys.shape == ref_keys.shape and keys.is_contiguous()
    err = (keys.float() - ref_keys).abs()
    scale = ref_keys.abs().max().item()
    if enc.dtype == torch.bfloat16:
        bar = 2.0 ** -8 * ref_keys.abs() + 1e-5 * scale
        worst = (err / bar).max().item()
        print(f"{name}: keys max err {err.max().item():.3e} of max |ref| {scale:.3e}, "
              f"{worst:.3f} of the bar")
        assert worst <= 1.0
    else:
        torch.testing.assert_close(keys, ref_keys, rtol=1e-4, atol=1e-4 * scale)
    for got, want in ((rows_tab, ref_rows), (cols_tab, ref_cols)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-6


def _ms(fn, iters=20):
    for _ in range(3):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


@pytest.mark.cuda
def test_bandwidth_at_2048(cuda_device):
    """CUDA events over 20 launches at the benchmark cells' shapes, 2048^2
    first: bytes are enc read once, the keys and both tables written once."""
    for name in ("2048", "448->2048", "448"):
        rope, enc, up, down = _case(cuda_device, name)
        with torch.no_grad():
            ms = _ms(lambda: rope_keys(rope, enc, up, down))
            plain = _ms(lambda: rope_keys_ref(rope, enc, up, down), iters=3)
        c = enc.shape[-1]
        nbytes = (enc.numel() * enc.element_size() + down[0] * down[1] * c * enc.element_size()
                  + (up[0] + up[1]) * 2 * c * 4)
        print(f"keys kernel at {name}: {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s "
              f"({nbytes / 3.35e12 * 1e3 / ms:.1%} of 3.35 TB/s); plain version {plain:.3f} ms "
              f"({torch.cuda.get_device_name(0)})")
        assert ms > 0


@pytest.mark.cuda
def test_one_launch_per_upsampler_call(cuda_device):
    ups = NAFUpsampler(model=load_naf_params(dtype=torch.bfloat16))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    image = torch.randn(1, 3, 448, 448, generator=gen, device=cuda_device).to(torch.bfloat16)
    feats = torch.randn(1, 384, 28, 28, generator=gen, device=cuda_device).to(torch.bfloat16)
    before = launch_counts()
    out = ups(image, feats, (448, 448))
    torch.cuda.synchronize()
    after = launch_counts()
    assert (after["keys"] - before["keys"], after["k1"] - before["k1"],
            after["k2"] - before["k2"]) == (1, 8, 1)
    assert out.shape == (1, 384, 448, 448) and bool(torch.isfinite(out).all())
