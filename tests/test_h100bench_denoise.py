"""The denoiser cell's reference, counts and limits on the CPU, at small
sizes (32^2, dim 32, k 5, one head, batch 2), with no JAX:

- ``h100bench/reference/denoise.py``'s blocked attention against
  ``reference/naf.py``'s plain one, forward and gradients;
- the port's denoise step (``make_denoise_chunk`` over
  ``make_denoise_step``, as the cell drives it) against the reference in
  f32: the loss, every leaf's gradient and the masters after two AdamW
  steps; the same step with a bf16 working copy fails one of the checks;
- ``h100bench/work_na.py``'s K3/K4 operations and bytes against a count of
  their tensors and ``FlopCounterMode``;
- ``correct`` against the cell's own limits: a sound run passes; the float8
  control and each fault of ``calibrate_denoise.FAULTS``, planted under the
  timed path, fail, each by the number it names;
- the stack's images, ``noise_z`` and ``grad_rel_l2``;
- a run of the cell loads no JAX.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import calibrate_denoise, check, work, work_na
from h100bench.kinds import denoise
from h100bench.reference import naf as ref_naf
from h100bench.reference.denoise import blocked_attention, denoise_steps

ROOT = Path(__file__).resolve().parents[1]
CELL = "naf-denoise-k15.train"
TRAFFIC = {"kind": "denoise", "chunk_steps": 1, "stack_images": 8, "checked_steps": 3}
SEED = 2**31 + 2021
CPU = torch.device("cpu")

# Each tolerance holds the port's f32 step to the reference's. Both compute
# in f32 and differ only in the order of their sums (the port's CPU encoder
# runs nn.GroupNorm and nn.Conv2d, its attention the plain gather; the
# reference runs its own convs and dense blocks of logits). Over eight
# seeds the f32 readings are at most 1.4e-6 (loss), 1.1e-5 (gradients) and
# 2.8e-3 (masters' change). The room above them is for an output that lies
# within rounding of its clean pixel: there the L1 term's kink gives the two
# sides opposite signs, the gradient moves by 2.2e-3, and Adam's first
# step, which moves each element by about lr * sign(g), moves the elements
# whose gradient is near nought the other way (6.6e-2; seen on a stack of
# uniform-noise images). A bf16 working copy reads at least 3.6e-4, 1.8e-2
# and 0.12 on those seeds.
LOSS_RTOL = 2e-5  # relative gap of each step's loss
GRAD_RTOL = 1e-2  # ||g - g_ref|| / ||g_ref||, the worst leaf
DELTA_RTOL = 0.1  # ||(p - p0) - (p_ref - p0)|| / ||p_ref - p0||, the worst leaf


def small(use_bf16: bool = True) -> dict:
    cfg = json.loads((ROOT / "h100bench" / "configs" / "naf-denoise-k15.json").read_text())
    cfg["img_size"] = 32
    cfg["model"].update(dim=32, kernel_size=5)
    cfg["train"].update(batch_size=2, use_bf16=use_bf16)
    return cfg


@pytest.mark.parametrize("hq,hk,k,heads,rows", [((16, 16), (16, 16), 5, 1, 3),
                                                ((24, 20), (6, 5), 3, 2, 4),
                                                ((12, 12), (4, 4), 3, 1, 8)])
def test_blocked_attention_is_the_plain_attention(hq, hk, k, heads, rows):
    """The same f64 dot products, summed in another order: 1e-12."""
    gen = torch.Generator().manual_seed(0)
    ins = [torch.randn(2, *hw, c, generator=gen, dtype=torch.float64, requires_grad=True)
           for hw, c in ((hq, 16), (hk, 16), (hk, 6))]
    got = blocked_attention(*ins, heads, k, block_rows=rows)
    want = ref_naf.cross_scale_attention(*ins, heads, k)
    g = torch.randn(got.shape, generator=gen, dtype=torch.float64)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for a, b in zip(torch.autograd.grad(got, ins, g), torch.autograd.grad(want, ins, g)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _two_steps(use_bf16: bool):
    """The port's first two steps and the reference's on their batches:
    (losses, gradients, masters' change) for each side."""
    cfg = small(use_bf16)
    prog = denoise.Program(cfg, TRAFFIC, SEED, CPU)
    losses, rows, grads = [], [], None
    for _ in range(2):
        loss, idx = prog.run_chunk(1)
        losses.append(float(loss[0]))
        rows.append(idx[0])
        if grads is None:
            grads = {k: p.grad.clone() for k, p in prog.model.named_parameters()}
    delta = {k: p.detach() - prog.naf_init[k] for k, p in prog.model.named_parameters()}
    cleans, noisies = denoise.checked_batches(prog, rows)
    assert not torch.equal(noisies[0], noisies[1]) and len(set(rows[0]) | set(rows[1])) == 4
    return (losses, grads, delta), denoise_steps(prog.naf_init, cfg, cleans, noisies)


def _gaps(prog, ref):
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    return (max(abs(p - r) / abs(r) for p, r in zip(prog[0], ref[0])),
            max(rel(prog[1][k], ref[1][k]) for k in ref[1]),
            max(rel(prog[2][k], ref[2][k]) for k in ref[2]))


def test_port_step_matches_the_reference_in_f32():
    prog, ref = _two_steps(use_bf16=False)
    assert set(prog[1]) == set(ref[1]) and len(ref[1]) == 36
    loss, grad, delta = _gaps(prog, ref)
    assert loss <= LOSS_RTOL and grad <= GRAD_RTOL and delta <= DELTA_RTOL, (loss, grad, delta)


def test_a_bf16_working_copy_fails_a_tolerance():
    loss, grad, delta = _gaps(*_two_steps(use_bf16=True))
    assert loss > LOSS_RTOL or grad > GRAD_RTOL or delta > DELTA_RTOL, (loss, grad, delta)


def test_k3_k4_bytes_are_their_tensors():
    b, q_hw, lr_hw, heads, k, d, dv = 2, (12, 10), (6, 5), 2, 3, 8, 3
    t = lambda *hw, c: torch.empty(b, *hw, heads, c, dtype=torch.bfloat16)  # noqa: E731
    q, keys, v, out = t(*q_hw, c=d), t(*lr_hw, c=d), t(*lr_hw, c=dv), t(*q_hw, c=dv)
    size = lambda *ts: sum(x.numel() * x.element_size() for x in ts)  # noqa: E731
    assert work_na.k3_work(b, q_hw, lr_hw, heads, k, d, dv)[1] == size(q, keys, v, out)
    # K4 reads q, keys, values and dO and writes dq, dk and dv
    assert work_na.k4_work(b, q_hw, lr_hw, heads, k, d, dv)[1] == size(q, keys, v, out, q, keys, v)


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("q_hw,lr_hw,k", [((16, 16), (4, 4), 3), ((8, 8), (8, 8), 5)])
def test_k3_k4_flops(q_hw, lr_hw, k):
    """K3 is the attention's forward. K4 is its backward, four products,
    with the logits recomputed: the forward and backward less the forward's
    probabilities times values."""
    heads, d, dv = 2, 8, 6
    ins = [torch.randn(1, *hw, heads * c, requires_grad=True)
           for hw, c in ((q_hw, d), (lr_hw, d), (lr_hw, dv))]
    fwd = _flops(lambda: ref_naf.cross_scale_attention(*ins, heads, k))
    both = _flops(lambda: ref_naf.cross_scale_attention(*ins, heads, k).sum().backward())
    pv = 1 * q_hw[0] * q_hw[1] * heads * k * k * 2 * dv
    assert work_na.k3_work(1, q_hw, lr_hw, heads, k, d, dv)[0] == fwd
    assert work_na.k4_work(1, q_hw, lr_hw, heads, k, d, dv)[0] == both - pv
    f34, n34 = work_na.k34_work(1, q_hw, lr_hw, heads, k, d, dv)
    assert f34 == both - pv + fwd


def test_the_cells_work_at_its_shape():
    cfg = json.loads((ROOT / "h100bench" / "configs" / "naf-denoise-k15.json").read_text())
    got = denoise.work_per_step(cfg)
    card = "NVIDIA H100 80GB HBM3"
    bound_ms = [1e3 * work.bound_s(*work_na.k3_work(8, (448, 448), (448, 448), 1, 15, 256, 3),
                                   card),
                1e3 * work.bound_s(*work_na.k4_work(8, (448, 448), (448, 448), 1, 15, 256, 3),
                                   card)]
    assert bound_ms == pytest.approx([0.4965, 0.9902], abs=1e-4)  # bytes-bound
    assert got["k34"][1] == (work_na.k3_work(8, (448, 448), (448, 448), 1, 15, 256, 3)[1]
                             + work_na.k4_work(8, (448, 448), (448, 448), 1, 15, 256, 3)[1])
    assert got["flops"] == 3 * work.naf_forward_flops(8, (448, 448), (448, 448), cfg["model"], 3)


def _run():
    res = denoise.run(small(), TRAFFIC, SEED, 0.0, False, CPU, 0.0)
    return check.judge(res["numbers"], check.load_limits(CELL)), res["numbers"]


def test_limits_file_records_its_readings():
    limits = json.loads((ROOT / "h100bench" / "limits" / f"{CELL}.json").read_text())
    assert set(limits) == {"loss_gap", "grad_gap", "delta_gap", "pred_rel_l2", "loss_fn_gap",
                           "grad_rel_l2", "noise_z"}
    for v in limits.values():
        assert v["lower"] < v["limit"] < v["upper"], v


def _over(checks, name):
    return checks[name]["value"] > checks[name]["limit"]


def test_sound_run_passes_and_the_control_fails():
    (ok, checks), _ = _run()
    assert ok, checks
    nums = denoise.control_numbers(small(), TRAFFIC, SEED, CPU)
    ok, checks = check.judge(nums, check.load_limits(CELL))
    assert not ok and _over(checks, "pred_rel_l2"), checks


@pytest.mark.parametrize("fault", sorted(calibrate_denoise.FAULTS))
def test_planted_fault_fails(fault):
    """Each fault the card's calibration plants, planted here under the
    timed path, fails the cell's limits by the number it names."""
    plant, number = calibrate_denoise.FAULTS[fault]
    with plant():
        (ok, checks), nums = _run()
    assert not ok and _over(checks, number), checks
    if fault == "state_unchanged":
        assert nums["delta_gap"] == pytest.approx(1.0)
    if fault == "half_batch_backward":  # the reported loss and the forward stay whole
        assert not _over(checks, "loss_fn_gap") and not _over(checks, "pred_rel_l2"), checks


def test_images_differ_in_their_statistics():
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a, b = denoise.images(gen(3), 16, 32), denoise.images(gen(3), 16, 32)
    assert torch.equal(a, b) and a.shape == (16, 32, 32, 3) and a.dtype == torch.float32
    assert float(a.amin()) >= 0.0 and float(a.amax()) <= 1.0
    means, stds = a.mean(dim=(1, 2, 3)), a.std(dim=(1, 2, 3))
    assert float(means.max() - means.min()) > 0.3 and float(stds.max() / stds.min()) > 4
    assert not torch.equal(a, denoise.images(gen(4), 16, 32))


def test_noise_z_reads_standard_errors():
    gen = torch.Generator().manual_seed(5)
    den = {"noise_type": "gaussian", "noise_params": {"std": 0.5}}
    cleans = [torch.rand(2, 64, 64, 3, generator=gen) for _ in range(3)]
    noisy = lambda s: [c + s * torch.randn(c.shape, generator=gen) for c in cleans]  # noqa: E731
    assert denoise.noise_z(cleans, noisy(0.5), den) < 5  # six draws of a standard normal
    n = cleans[0].numel()  # sigma 10% high: 0.1 sqrt(2n) standard errors, 22
    assert denoise.noise_z(cleans, noisy(0.55), den) == pytest.approx(0.1 * (2 * n) ** 0.5, abs=4)
    shifted = [c + 0.5 * torch.randn(c.shape, generator=gen) + 0.05 for c in cleans]
    assert denoise.noise_z(cleans, shifted, den) > 0.09 * n ** 0.5  # 0.1 sqrt(n), 16
    with pytest.raises(ValueError):
        denoise.noise_z(cleans, noisy(0.5), {"noise_type": "salt_pepper", "noise_params": {}})


def test_grad_rel_l2_takes_every_leaf_as_one_vector():
    ref = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([[4.0]])}
    got = {"a": torch.tensor([3.0, 1.0]), "b": torch.tensor([[2.0]])}
    assert denoise.grad_rel_l2(got, ref) == pytest.approx(5 ** 0.5 / 5)


def test_weights_and_noise_follow_the_seed():
    a = denoise.Program(small(), TRAFFIC, 2**33 + 1, CPU)
    b = denoise.Program(copy.deepcopy(small()), TRAFFIC, 2**33 + 1, CPU)
    c = denoise.Program(small(), TRAFFIC, 2**33 + 2, CPU)
    assert all(torch.equal(a.naf_init[k], b.naf_init[k]) for k in a.naf_init)
    assert torch.equal(a.stack, b.stack) and not torch.equal(a.stack, c.stack)
    clean = a.stack[:2]
    assert torch.equal(a.noisy(1, clean), b.noisy(1, clean))
    assert not torch.equal(a.noisy(1, clean), a.noisy(2, clean))


NO_JAX = r"""
import json, sys
sys.path.insert(0, "tests")
from h100bench import run
from test_h100bench_denoise import TRAFFIC, small
run.run_cell({"name": "c"}, small(), TRAFFIC, 1, 0.1, False, "cpu", limits={})
print(json.dumps({"loaded": run.forbidden_modules()}))
"""


def test_a_denoise_run_loads_no_jax():
    """What the cell runs (the kind, the reference, the port's denoise step)
    loads neither JAX nor the JAX package: a fresh process on the CPU."""
    out = subprocess.run([sys.executable, "-c", NO_JAX], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["loaded"] == []
