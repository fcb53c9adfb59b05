"""The keys kernel's module (``naf_torch.kernels.rope_keys``) on the CPU: its
plain version against ``RoPE.pooled`` + ``RoPE.tables`` and the pool-RoPE-pool
chain written out; a numpy emulation of the kernel's arithmetic (each
channel and its rotate-half partner as one complex number, per-axis complex
composite weights found by inverting the pool windows, the tables from the
coordinates and periods in f32)
against the same; the launch plan's limits; the routing rule; and that the
CPU path launches nothing. The kernel itself runs on the card:
``tests/test_torch_card_rope_keys.py``."""

import types

import numpy as np
import pytest
import torch

from naf_torch.api import load_naf_params
from naf_torch.kernels import launch_counts
from naf_torch.kernels import rope_keys as rk
from naf_torch.nn.rope import RoPE
from naf_torch.ops.pool import adaptive_avg_pool2d

torch.set_num_threads(1)

# (enc hi, wi, up oh, ow, down hk, wk, batch, C, RoPE heads)
SHAPES = {
    "equal": (16, 16, 16, 16, 4, 4, 1, 32, 2),
    "ragged-up": (7, 9, 32, 40, 5, 6, 1, 32, 2),
    "davis-down": (24, 40, 48, 80, 7, 11, 1, 32, 2),
    "guard-down": (40, 36, 20, 18, 6, 5, 1, 64, 4),
    "batch2": (12, 20, 24, 40, 6, 10, 2, 24, 2),
}


def _case(name, seed=0):
    hi, wi, oh, ow, hk, wk, b, c, heads = SHAPES[name]
    rng = np.random.RandomState(seed)
    enc = torch.from_numpy(rng.randn(b, hi, wi, c).astype(np.float32))
    return RoPE(c, heads), enc, (oh, ow), (hk, wk)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_version_is_pooled_and_tables(name):
    rope, enc, up, down = _case(name)
    keys, rows_tab, cols_tab = rk.rope_keys_ref(rope, enc, up, down)
    sin_r, cos_r, sin_c, cos_c = rope.tables(*up)
    assert keys.is_contiguous() and keys.shape == (enc.shape[0], *down, enc.shape[-1])
    torch.testing.assert_close(keys, rope.pooled(enc, up, down), rtol=0, atol=0)
    torch.testing.assert_close(rows_tab, torch.cat([cos_r, sin_r], -1), rtol=0, atol=0)
    torch.testing.assert_close(cols_tab, torch.cat([cos_c, sin_c], -1), rtol=0, atol=0)
    chain = adaptive_avg_pool2d(rope(adaptive_avg_pool2d(enc, up)), down)
    torch.testing.assert_close(keys, chain, rtol=2e-5, atol=2e-5)


def _lo(o, n, m):
    return o * n // m


def _hi(o, n, m):
    return -(-(o + 1) * n // m)


def _angles(n, periods):
    """(n, nf) f32 angles as the kernel computes them: the coordinate
    2 (y + 0.5) / n - 1, then (f32(2 pi) * coordinate) / period."""
    f32 = np.float32
    coord = f32(2.0) * (np.arange(n, dtype=f32) + f32(0.5)) / f32(n) - f32(1.0)
    return (f32(2 * np.pi) * coord)[:, None] / periods[None, :]


def _axis(n_in, n_mid, n_out, ang):
    """The kernel's complex composite weights along one axis (n_in -> n_mid
    -> n_out): free (n_out, n_in) and angled (n_out, n_in, nf), each enc
    position's middle positions found by pooling its window the other way."""
    free = np.zeros((n_out, n_in))
    angled = np.zeros((n_out, n_in, ang.shape[1]), dtype=complex)
    for k in range(n_out):
        y0, y1 = _lo(k, n_mid, n_out), _hi(k, n_mid, n_out)
        for e in range(_lo(y0, n_in, n_mid), _hi(y1 - 1, n_in, n_mid)):
            for y in range(max(y0, _lo(e, n_mid, n_in)), min(y1, _hi(e, n_mid, n_in))):
                p = 1.0 / (y1 - y0) / (_hi(y, n_in, n_mid) - _lo(y, n_in, n_mid))
                free[k, e] += p
                angled[k, e] += p * np.exp(1j * ang[y].astype(np.float64))
    return free, angled


def _emulate(rope, enc, up, down):
    """(keys, rows_tab, cols_tab) by the kernel's arithmetic, in float64:
    each channel c of a head's first half and its partner c + dh/2 as one
    complex number, key = sum_i R(i) sum_j Q(j) z[i, j]."""
    b, hi, wi, c = enc.shape
    (oh, ow), (hk, wk) = up, down
    dh, periods = rope.d_head, rope.periods.numpy()
    half, nf = dh // 2, dh // 4
    ang_r, ang_c = _angles(oh, periods), _angles(ow, periods)
    fr, ar = _axis(hi, oh, hk, ang_r)
    fc, ac = _axis(wi, ow, wk, ang_c)
    j = np.arange(c) % dh
    col_slot, f = (j % half) >= nf, j % nf  # column-angle channels, and each one's frequency
    first = j < half
    r = np.where(col_slot, fr[..., None], ar[..., f])[..., first]
    q = np.where(col_slot, ac[..., f], fc[..., None])[..., first]
    x = enc.double().numpy().reshape(b, hi, wi, c // dh, 2, half)
    z = (x[..., 0, :] + 1j * x[..., 1, :]).reshape(b, hi, wi, c // 2)
    kz = np.einsum("kic,ljc,bijc->bklc", r, q, z).reshape(b, hk, wk, c // dh, 1, half)
    keys = np.concatenate([kz.real, kz.imag], -2).reshape(b, hk, wk, c)

    def table(n, ang, angled):
        val = np.ones((n, c), dtype=np.float32)
        cos, sin = val.copy(), val.copy()
        cos[:, angled], sin[:, angled] = np.cos(ang[:, f[angled]]), np.sin(ang[:, f[angled]])
        return np.concatenate([cos, sin], -1)

    return keys, table(oh, ang_r, ~col_slot), table(ow, ang_c, col_slot)


@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_arithmetic_matches_the_plain_version(name):
    rope, enc, up, down = _case(name, seed=1)
    keys, rows_tab, cols_tab = rk.rope_keys_ref(rope, enc, up, down)
    want_keys, want_rows, want_cols = _emulate(rope, enc, up, down)
    np.testing.assert_allclose(want_keys, keys.double().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(want_rows, rows_tab.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(want_cols, cols_tab.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape, want", [
    ((1, 448, 448, 448, 448, 28, 28, 256, 64), (8, 16, 16, 1, 16, 16, 16384)),
    ((1, 448, 448, 2048, 2048, 128, 128, 256, 64), (8, 16, 2, 8, 4, 4, 16384)),
    ((1, 2048, 2048, 2048, 2048, 128, 128, 256, 64), (8, 16, 2, 8, 16, 16, 36864)),
    ((4, 2048, 2048, 2048, 2048, 128, 128, 256, 64), (8, 16, 1, 16, 16, 16, 69632)),
    ((1, 480, 854, 480, 854, 30, 53, 256, 64), (8, 16, 16, 1, 16, 18, 16384)),
    ((1, 448, 448, 448, 448, 28, 28, 96, 24), (4, 12, 16, 1, 16, 16, 6144)),
    ((1, 1792, 1792, 448, 448, 28, 28, 256, 64), (8, 16, 16, 1, 32, 32, 16384)),
    ((1, 64, 64, 64, 64, 1, 1, 4096, 256), (8, 256, 1, 1, 32, 32, 65536)),
])
def test_plan(shape, want):
    """The launch plan at the cells' shapes (448^2, 448^2 -> 2048^2, 2048^2,
    also at batch 4), DAVIS's 480 x 854 with 30 x 53 features, NAF(dim=96)'s
    d 24, the guard's 4:1 pool-down, and a window wider than a chunk on 256
    groups: at most 256 threads, chunks of at most CH, shared memory for
    both tables and for the row splits' partial keys, and fewer row splits
    only where the grid keeps MIN_BLOCKS blocks."""
    b, hi, wi, oh, ow, hk, wk, c, dh = shape
    plan = rk._plan(b, hi, wi, oh, ow, hk, wk, c, dh)
    assert plan == want
    v, gb, r, kx, rch, cch, smem = plan
    assert (dh // 2) % v == 0 and gb * r * kx <= rk.MAX_THREADS and max(rch, cch) <= rk.CH
    assert smem >= 8 * (rch + kx * cch) * dh // 2 and smem >= 4 * gb * r * kx * 2 * v
    blocks = b * hk * -(-wk // kx) * -(-c // (2 * v * gb))
    assert r == min(rch, rk.MAX_THREADS // gb) or blocks >= rk.MIN_BLOCKS


def test_routing(monkeypatch):
    """CUDA tensors that need no gradient launch the kernel; CPU tensors and
    inputs under autograd take the plain version."""
    taken = []
    monkeypatch.setattr(rk, "_launch", lambda *a: taken.append("kernel"))
    monkeypatch.setattr(rk, "rope_keys_ref", lambda *a: taken.append("plain"))
    rope = RoPE(32, 2)
    cuda = torch.device("cuda")  # a device object only: nothing is allocated on it

    def enc(device, grad=False):
        return types.SimpleNamespace(device=device, requires_grad=grad)

    calls = [
        (enc(cuda), "kernel"),
        (enc(torch.device("cpu")), "plain"),
        (enc(cuda, grad=True), "plain"),
    ]
    for x, want in calls:
        rk.rope_keys(rope, x, (16, 16), (4, 4))
        assert taken.pop() == want, x
    with torch.no_grad():  # no gradient is needed where autograd is off
        rk.rope_keys(rope, enc(cuda, grad=True), (16, 16), (4, 4))
    assert taken == ["kernel"]


def test_cpu_forward_launches_no_keys_kernel():
    before = launch_counts()
    assert before["keys"] == rk.rope_keys.launches
    model = load_naf_params(device="cpu", dim=32, heads_attn=2, heads_rope=2, kernel_size=3)
    gen = torch.Generator().manual_seed(0)
    image, feats = torch.randn(1, 32, 32, 3, generator=gen), torch.randn(1, 4, 4, 16,
                                                                           generator=gen)
    with torch.no_grad():
        out = model(image, feats, (32, 32))
    assert out.shape == (1, 32, 32, 16) and launch_counts()["keys"] == before["keys"]
