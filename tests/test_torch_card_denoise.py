"""The denoising slice on the card: the chunked f32 K2, K3 and K4
("fma_chunked": boxes that do not fit shared memory whole, walked in chunks)
against their plain versions (2e-4 forward, 2e-3 gradients), at small
shapes under lowered shared-memory limits (chunks of whole box rows and of
part of a row) and at the denoiser's attention (one head, d 256, dv 3, k 15,
ratio 1) at 64^2; the planner's shared-memory sums against the kernels'
own; one f32 denoiser step on the card against the same step on the CPU.

``SmemFormulas`` mirrors the kernels' shared-memory sums in Python, in the
shape of the kernel libraries' C functions, so that the CPU tests can plan
with it (``tests/test_torch_chunked_f32.py``); a card test holds it to the
libraries.

Every test that needs the card carries the marker ``cuda`` and skips
without one. The file imports no JAX:

    python -m pytest -m cuda tests/test_torch_card_denoise.py -q
"""

import pytest
import torch

from naf_torch.kernels import na2d_fused as t_na
from naf_torch.kernels import na2d_fused_q as t_q
from naf_torch.kernels.na2d_fused import (
    cross_scale_na2d_fused,
    cross_scale_na2d_fused_bwd_ref,
    cross_scale_na2d_fused_ref,
)
from naf_torch.kernels.na2d_fused_q import naf_upsample_attention, naf_upsample_attention_ref

WARPS = 8


def _r4(v):
    return (v + 3) & ~3


class SmemFormulas:
    """The f32 kernels' dynamic shared memory in bytes (``fwd_smem``,
    ``bwd_smem``, ``*_chunk_smem`` of ``csrc/na2d_fused.cu``; ``smem_bytes``,
    ``chunk_smem_bytes`` of ``csrc/na2d_fused_q.cu``), named as the
    libraries export them."""

    @staticmethod
    def naf_na_fwd_smem(d, dv, ks, urh, urw):
        nc = urh * urw
        return 4 * (nc * (d + 4) + nc * (dv + 4) + WARPS * d + 2 * WARPS * ks * ks)

    @staticmethod
    def naf_na_bwd_smem(d, dv, ks, urh, urw):
        nc = urh * urw
        return 4 * (nc * (d + 4) + nc * (dv + 4) + nc * (d + dv) + WARPS * (d + dv)
                    + 3 * WARPS * ks * ks)

    @staticmethod
    def naf_na_fwd_chunk_smem(d, dv, ks, nq, nc):
        return 4 * (nc * (d + 4) + nc * (dv + 4) + WARPS * d + 2 * WARPS * ks * ks + 2 * nq)

    @staticmethod
    def naf_na_bwd_chunk_smem(d, dv, ks, nq, nc):
        return 4 * (nc * (d + 4) + nc * (dv + 4) + nc * (d + dv) + WARPS * (d + dv)
                    + 3 * WARPS * ks * ks + WARPS + 3 * nq)

    @staticmethod
    def naf_fused_q_smem(d, dv, ks, urh, urw):
        nc = urh * urw
        return 4 * (nc * (d + 4) + _r4(nc * dv) + WARPS * d + 2 * WARPS * ks * ks)

    @staticmethod
    def naf_fused_q_chunk_smem(d, dv, ks, nq, nc):
        return 4 * (nc * (d + 4) + _r4(nc * dv) + WARPS * d + 2 * WARPS * ks * ks + 2 * nq)


# (batch, Hq, hk, k, d, dv, lowered SMEM_MAX in bytes), each chunked on K2,
# K3 and K4: chunks of whole box rows; of part of one row; the ragged ratio
# 40 <- 14 with repeated cells (K2 and K3 in whole rows, K4 in part rows)
CHUNKED = {
    "rows": (2, 24, 24, 9, 32, 8, 12 * 1024),
    "part_row": (1, 32, 32, 5, 128, 4, 8 * 1024),
    "ragged": (1, 40, 14, 5, 64, 4, 6 * 1024),
}
DENOISER = (1, 64, 64, 15, 256, 3)  # the denoiser's attention at 64^2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py holds the kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, hq, hk, d, dv, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, h, h, 1, c, generator=gen, device=dev)
            for h, c in ((hq, d), (hk, d), (hk, dv), (hq, dv))]


def _lower_limits(monkeypatch, limit):
    for mod in (t_na, t_q):
        monkeypatch.setattr(mod, "SMEM_BUDGET", limit)
        monkeypatch.setattr(mod, "SMEM_MAX", limit)


def _k34_chunked(q, k, v, g, ks):
    want = cross_scale_na2d_fused_ref(q, k, v, ks)
    want_g = cross_scale_na2d_fused_bwd_ref(q, k, v, g, ks)
    before = dict(t_na.cross_scale_na2d_fused.route_launches)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = cross_scale_na2d_fused(*ins, ks)
    got = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    after = t_na.cross_scale_na2d_fused.route_launches
    assert after["fma_chunked"] == before["fma_chunked"] + 1
    assert after["fma_chunked_bwd"] >= before["fma_chunked_bwd"] + 1
    torch.testing.assert_close(out, want, atol=2e-4, rtol=2e-4)
    for a, w in zip(got, want_g):
        torch.testing.assert_close(a, w, atol=2e-3, rtol=2e-3)


def _k2_inputs(dev, b, hq, hk, d, dv, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc = torch.randn(b, hq, hq, d, generator=gen, device=dev)
    keys = torch.randn(b, hk, hk, d, generator=gen, device=dev)
    values = torch.randn(b, hk, hk, dv, generator=gen, device=dev)
    tabs = [torch.rand(hq, 2 * d, generator=gen, device=dev) for _ in range(2)]
    return enc, keys, values, *tabs


def _k2_chunked(enc, keys, values, rt, ct, ks):
    d = enc.shape[-1]
    kw = dict(num_heads=1, kernel_size=ks)
    before = t_q.naf_upsample_attention.route_launches["fma_chunked"]
    got = naf_upsample_attention(enc, keys, values, rt, ct, d, **kw)
    torch.cuda.synchronize()
    assert t_q.naf_upsample_attention.route_launches["fma_chunked"] == before + 1
    want = naf_upsample_attention_ref(enc, keys, values, rt, ct, d, **kw)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_smem_formulas_match_the_libraries(cuda_device):
    libs = {"na": t_na._lib(), "q": t_q._lib()}
    for name in dir(SmemFormulas):
        if not name.startswith("naf_"):
            continue
        lib = libs["q" if "fused_q" in name else "na"]
        for args in ((256, 4, 15, 22, 22), (64, 96, 9, 5, 5), (16, 3, 5, 64, 7), (8, 1, 3, 1, 1)):
            assert getattr(lib, name)(*args) == getattr(SmemFormulas, name)(*args), (name, args)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(CHUNKED))
def test_chunked_f32_k3_k4_match_plain_on_card(cuda_device, label, monkeypatch):
    b, hq, hk, ks, d, dv, limit = CHUNKED[label]
    _lower_limits(monkeypatch, limit)
    q, k, v, g = _inputs(cuda_device, b, hq, hk, d, dv)
    _k34_chunked(q, k, v, g, ks)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(CHUNKED))
def test_chunked_f32_k2_matches_plain_on_card(cuda_device, label, monkeypatch):
    b, hq, hk, ks, d, dv, limit = CHUNKED[label]
    _lower_limits(monkeypatch, limit)
    _k2_chunked(*_k2_inputs(cuda_device, b, hq, hk, d, dv), ks)


@pytest.mark.cuda
def test_chunked_f32_at_the_denoisers_attention(cuda_device):
    b, hq, hk, ks, d, dv = DENOISER
    q, k, v, g = _inputs(cuda_device, b, hq, hk, d, dv, seed=2)
    _k34_chunked(q, k, v, g, ks)
    _k2_chunked(*_k2_inputs(cuda_device, b, hq, hk, d, dv, seed=3), ks)


@pytest.mark.cuda
def test_whole_box_shapes_keep_their_route(cuda_device):
    """A shape whose box fits shared memory whole stays on the whole-box
    kernels."""
    q, k, v, g = _inputs(cuda_device, 1, 48, 12, 16, 4)
    before = dict(t_na.cross_scale_na2d_fused.route_launches)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(cross_scale_na2d_fused(*ins, 5), ins, g)
    after = t_na.cross_scale_na2d_fused.route_launches
    assert after["fma"] == before["fma"] + 1 and after["fma_bwd"] == before["fma_bwd"] + 1
    assert after["fma_chunked"] == before["fma_chunked"]


def denoiser_step_on(model, device, clean, noise):
    """One f32 denoiser step of ``model`` (moved to ``device``) on ``clean``
    with ``noise`` added: (loss, flat gradient)."""
    from naf_torch.evals.denoising import DenoisingLoss
    from naf_torch.train.denoise import DenoiseConfig, make_denoise_step, make_optimizer

    model = model.to(device)
    noise = noise.to(device)
    step = make_denoise_step(model, make_optimizer(model, DenoiseConfig()),
                             DenoisingLoss(1.0, 5.0, 0.2), lambda _g, img, _p: img + noise, None,
                             clean.shape[1:3], use_bf16=False)
    loss = float(step(clean.to(device), None))
    return loss, torch.cat([p.grad.flatten().cpu() for p in model.parameters()])


@pytest.mark.cuda
def test_f32_denoiser_step_on_card_matches_cpu(cuda_device):
    """The denoiser (one head, k 15, ratio 1; the f32 K2 forward and the
    chunked-or-whole f32 K3 / K4 backward) on the card against the CPU."""
    import copy

    from naf_torch.api import _init_weights
    from naf_torch.models.naf import NAF

    model = NAF(dim=32, heads_attn=1, heads_rope=1, kernel_size=15, img_layers=1)
    _init_weights(model, 0)
    gen = torch.Generator().manual_seed(4)
    clean, noise = torch.rand(1, 32, 32, 3, generator=gen), 0.5 * torch.randn(1, 32, 32, 3,
                                                                             generator=gen)
    cpu_loss, cpu_grad = denoiser_step_on(copy.deepcopy(model), "cpu", clean, noise)
    card_loss, card_grad = denoiser_step_on(model, cuda_device, clean, noise)
    assert abs(card_loss - cpu_loss) <= 1e-3 * abs(cpu_loss)
    cos = float(card_grad.double() @ cpu_grad.double()
                / (card_grad.double().norm() * cpu_grad.double().norm()))
    assert cos > 0.999


@pytest.mark.cuda
def test_reference_ssim_gradient_on_card(cuda_device):
    """The benchmark's plain SSIM (``h100bench/reference/denoise.py``) and
    the port's SSIM loss take the CPU's gradient on the card, in full f32.
    avg_pool2d's CUDA backward on a permuted NHWC view is wrong (105% of
    the exact gradient away, torch 2.11), so the reference pools
    contiguous copies."""
    from h100bench.reference.denoise import ssim
    from naf_torch.evals.denoising import ssim_loss

    gen = torch.Generator().manual_seed(6)
    clean = torch.rand(2, 48, 48, 3, generator=gen)
    pred = clean + 0.1 * torch.randn(clean.shape, generator=gen)

    def grads(device):
        out = []
        for fn in (lambda p, t: 1.0 - ssim(p, t), ssim_loss):
            x = pred.to(device).requires_grad_(True)
            (g,) = torch.autograd.grad(fn(x, clean.to(device)), x)
            out.append(g.cpu().double())
        return out

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        cpu, card = grads("cpu"), grads(cuda_device)
    for g in (*card, cpu[1]):  # the f32 sums in another order: 1e-5 of the norm
        assert float((g - cpu[0]).norm() / cpu[0].norm()) < 1e-4
