"""The port's measurement layer (naf_torch.bench.harness, naf_torch.utils.
benchmarking / profiling, the bench CLI) against naf_tpu.bench.harness, on
the CPU at small shapes.

Held against the JAX package: the sweep protocol (``_config_from_factor``)
and the row merge (``_merge_row``, on the cases of test_bench_harness.py)
exactly; the parameter counts of all six sweep models exactly; the skip rows
of ``_bench_one`` with whitespace normalized; NAF's bench loss and SGD step
(weights carried across) at atol = rtol = 2e-4, its gradients at 2e-3; the
keys of a row. On the port alone: the fake-tensor FLOP count against a real
CPU count, the row's own TF32 switches, the CPU timer and profiler, and that
every default entry point raises without CUDA.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from naf_torch.bench import __main__ as bench_cli
from naf_torch.bench import harness as th
from naf_torch.convert import state_dict_from_jax_params
from naf_torch.models.naf import NAF
from naf_torch.models.registry import build_model
from naf_torch.utils import benchmarking, profiling
from naf_tpu.bench import harness as jh
from naf_tpu.models.naf import NAF as JNAF
from naf_tpu.models.registry import ModelWrapper as JWrapper

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("factor", list(jh.SWEEPS))
def test_config_from_factor_matches_jax(factor):
    assert th.SWEEPS == jh.SWEEPS and th.DEFAULTS == jh.DEFAULTS and th.MODELS == jh.MODELS
    for value in jh.SWEEPS[factor]:
        assert th._config_from_factor(factor, value) == jh._config_from_factor(factor, value)


# the cases of tests/test_bench_harness.py, as (old, new)
MERGE_CASES = {
    "measured_mem_with_provenance": (
        {"model": "NAF", "fwd_ms": 10.0, "bwd_ms": 30.0, "fwd_mem_measured_mb": 1536,
         "bwd_mem_measured_mb": 4608, "mem_measured_method": "oom-bisect, one trial per subprocess",
         "mem_measured_at": "abc1234"},
        {"model": "NAF", "fwd_ms": 9.0, "bwd_ms": 28.0}),
    "never_downgrades_backward": (
        {"model": "NAF", "fwd_ms": 10.0, "bwd_ms": 30.0, "bwd_mem_mb": 4000.0},
        {"model": "NAF", "fwd_ms": 9.5,
         "bwd_skip": "backward disabled for this run (--no-backward)"}),
    "structured_backward_failure": (
        {"model": "NAF", "fwd_ms": 10.0, "bwd_ms": 30.0},
        {"model": "NAF", "fwd_ms": 9.5, "bwd_error": "HTTP 500"}),
    "fresh_measurement_wins": (
        {"model": "NAF", "bwd_ms": 3092.0},
        {"model": "NAF", "fwd_ms": 9.5, "bwd_ms": 120.0}),
    "no_old_row": (None, {"model": "NAF", "fwd_ms": 9.5}),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_row_matches_jax(case):
    old, new = MERGE_CASES[case]
    copy = lambda d: None if d is None else dict(d)
    assert th._merge_row(copy(old), copy(new)) == jh._merge_row(copy(old), copy(new))


@pytest.mark.parametrize("name", jh.MODELS)
@pytest.mark.parametrize("embed_dim,ratio,lr", [(384, 16, 2), (128, 4, 3)])
def test_count_params_matches_jax(name, embed_dim, ratio, lr):
    """JAX's count over ModelWrapper's params (shapes only, by
    ``jax.eval_shape``), at the smallest init shapes that leave it as it is
    at the sweep's; the port counts what its forward reads."""
    hr = lr * ratio
    shapes = ((1, hr, hr, 3), (1, lr, lr, embed_dim), (hr, hr))
    params = jax.eval_shape(lambda: JWrapper(name, embed_dim=embed_dim, ratio=ratio,
                                             init_shapes=shapes).params)
    want = jh._count_params(params)
    got = th._count_params(build_model(name, embed_dim, ratio), hr, lr, embed_dim, hr)
    assert got == want


def test_reference_counts_of_the_sweep_defaults():
    """BASELINE.md:33-36: NAF 662,528 and FeatUp 173,540 on the reference's
    A100 run; the port and the JAX package count the same at the defaults."""
    counts = {name: th._count_params(build_model(name, 384, 16), 32, 2, 384, 32)
              for name in ("NAF", "FeatUp")}
    assert counts == {"NAF": 662528, "FeatUp": 173540}


def _norm(row):
    return {k: re.sub(r"\s+", " ", v) if k == "skip" else v for k, v in row.items()}


@pytest.mark.parametrize("name,cfg", [
    ("FeatUp", jh._config_from_factor("ratio", 32)),  # JBUStack's ratio assert
    # NAF at img_size 112 with an output below the window (k = 9 > 8 rows)
    ("NAF", dict(img_size=112, embed_dim=8, ratio=8, lr_size=1, out_size=8)),
], ids=["featup_r32", "naf_img112_out_below_kernel"])
def test_bench_one_skip_rows_match_jax(name, cfg):
    want = jh._bench_one(name, cfg, jnp.float32, True)
    got = th._bench_one(name, cfg, torch.float32, True, iters=1, repeats=1, device="cpu")
    assert "skip" in want
    assert _norm(got) == _norm(want)


def test_bench_one_error_and_not_implemented_rows(monkeypatch):
    cfg = th._config_from_factor("ratio", 4)

    def raising(exc):
        def fn(*args, **kwargs):
            raise exc
        return fn

    monkeypatch.setattr(th, "benchmark_model", raising(NotImplementedError("no such route")))
    assert th._bench_one("NAF", cfg, torch.float32, True, device="cpu")["skip"] == "no such route"
    monkeypatch.setattr(th, "benchmark_model", raising(ValueError("a kernel dispatch bug")))
    assert th._bench_one("NAF", cfg, torch.float32, True, device="cpu")["error"] == \
        "ValueError: a kernel dispatch bug"
    monkeypatch.setattr(th, "benchmark_model", raising(RuntimeError("launch failed")))
    row = th._bench_one("NAF", cfg, torch.bfloat16, True, device="cpu")
    assert row["error"] == "RuntimeError: launch failed" and row["dtype"] == "bfloat16"


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_naf_bench_step_matches_jax_grad():
    """The bench's backward (``harness.py:142-149``: mean((out @ head)^2),
    gradients for the parameters and the head, p -= 1e-3 g) on the
    production NAF at a tiny shape, against the same step by ``jax.grad``."""
    image, feats, out = _rand(0, 1, 32, 32, 3), _rand(1, 1, 4, 4, 8), (32, 32)
    head = _rand(2, 8, 8) * 0.01
    jm = JNAF()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(feats), out)["params"]

    def loss_fn(params, head):
        y = jm.apply({"params": params}, jnp.asarray(image), jnp.asarray(feats), out)
        return jnp.mean((y @ head) ** 2)

    want_loss, (g_params, g_head) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        params, jnp.asarray(head))
    new_params = jax.tree.map(lambda p, g: p - 1e-3 * g, params, g_params)

    model = NAF()
    model.load_state_dict(state_dict_from_jax_params(params))
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    head_t = torch.from_numpy(head).requires_grad_()
    loss = th._train_step(model, head_t, torch.from_numpy(image), torch.from_numpy(feats), out)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    want_state = state_dict_from_jax_params(new_params)
    want_grads = state_dict_from_jax_params(g_params)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_state[k].numpy(), **TOL, err_msg=k)
        if k.endswith("rope.periods"):
            continue
        np.testing.assert_allclose(((before[k] - v) / 1e-3).numpy(), want_grads[k].numpy(),
                                   atol=2e-3, rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(head_t.detach().numpy(), head - 1e-3 * np.asarray(g_head), **TOL)


def test_benchmark_model_row_has_every_key_of_jax_row():
    want = jh.benchmark_model("Bilinear", 16, 8, 4, out_size=16, iters=1)
    for name in jh.MODELS:
        got = th.benchmark_model(name, 16, 8, 4, out_size=16, iters=1, repeats=1,
                                 device="cpu")
        missing = set(want) - set(got)
        assert not missing, (name, missing)
        assert got["device"] == "cpu" and got["fwd_mem_mb"] is None
        assert got["fwd_ms_min"] <= got["fwd_ms"] <= got["fwd_ms_max"]
        assert ("note" in got) == (name == "AnyUp")
    row = th.benchmark_model("NAF", 16, 8, 4, out_size=16, iters=1, repeats=1,
                             backward=False, device="cpu")
    assert row["bwd_skip"] == jh.benchmark_model(
        "Bilinear", 16, 8, 4, out_size=16, iters=1, backward=False)["bwd_skip"]


@pytest.mark.parametrize("name", jh.MODELS)
def test_fake_flop_count_equals_cpu_count(name):
    """The census on fake tensors against torch's counter and the parameter
    reads over one forward on real CPU tensors."""
    model = build_model(name, 16, 4)
    fake = th._census(model, 32, 4, 16, 16)
    counter, reads = FlopCounterMode(display=False), th._ParamReads()
    with counter, reads, torch.no_grad():
        model(torch.zeros(1, 32, 32, 3), torch.zeros(1, 4, 4, 16), (16, 16))
    real = {"flops": counter.get_total_flops(),
            "params": sum(p.numel() for p in model.parameters() if id(p) in reads.ids)}
    assert fake == real
    if name not in ("Bilinear", "Nearest"):
        assert fake["flops"] > 0


@pytest.mark.parametrize("tf32", [False, True])
def test_row_sets_and_records_its_own_tf32(tf32, monkeypatch):
    """A row runs with TF32 as it asks, records that, and leaves the
    caller's switches as they were."""
    seen = []
    step = th._train_step

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return step(*args, **kwargs)

    monkeypatch.setattr(th, "_train_step", spy)
    caller = (not tf32, tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller[0])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller[1])
    row = th.benchmark_model("NAF", 16, 8, 4, out_size=16, iters=1, repeats=1, tf32=tf32,
                             device="cpu")
    assert row["tf32"] is tf32 and seen and set(seen) == {(tf32, tf32)}
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == caller


def test_run_sweep_merges_by_key_with_dtype(tmp_path, monkeypatch):
    rows = iter(range(100))

    def fake_row(name, img_size, embed_dim, lr_size, out_size=None, dtype=torch.float32,
                 **kwargs):
        return {"model": name, "img_size": img_size, "embed_dim": embed_dim,
                "ratio": out_size // lr_size, "lr_size": lr_size, "out_size": out_size,
                "dtype": th._dtype_name(dtype), "fwd_ms": float(next(rows))}

    monkeypatch.setattr(th, "benchmark_model", fake_row)
    path = str(tmp_path / "r.json")
    th.run_sweep("ratio", models=["NAF"], values=[2, 4], out_path=path, device="cpu")
    th.run_sweep("ratio", models=["NAF"], values=[4], out_path=path, dtype=torch.bfloat16,
                 device="cpu")
    th.run_sweep("ratio", models=["NAF"], values=[4], out_path=path, device="cpu")
    with open(path) as f:
        saved = json.load(f)
    got = {(r["ratio"], r["dtype"]): r["fwd_ms"] for r in saved}
    assert got == {(2, "float32"): 0.0, (4, "float32"): 3.0, (4, "bfloat16"): 2.0}
    assert all(r["factor"] == "ratio" for r in saved)


def test_device_time_stats_on_cpu():
    calls = []
    stats = benchmarking.device_time_stats(lambda x: calls.append(x), 1, iters=4, repeats=3,
                                           warmup=2, device="cpu")
    assert len(calls) == 2 + 4 * 3
    assert len(stats["samples"]) == 3
    assert stats["min"] <= stats["median"] <= stats["max"]
    x = torch.randn(64, 64)
    ms = benchmarking.device_time_ms(torch.mm, x, x, iters=3, repeats=3, device="cpu")
    assert ms > 0
    with pytest.raises(ValueError):
        benchmarking.device_time_ms(torch.mm, x, x, device="meta")


def test_profile_fn_writes_a_chrome_trace_on_cpu(tmp_path):
    x = torch.randn(32, 32)
    log_dir = profiling.profile_fn(torch.mm, x, x, log_dir=str(tmp_path / "t"), iters=2,
                                   device="cpu")
    with open(tmp_path / "t" / profiling.TRACE_FILE) as f:
        trace = json.load(f)
    assert log_dir == str(tmp_path / "t")
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_default_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = torch.zeros(2, 2)
    calls = [
        lambda: benchmarking.device_time_ms(torch.mm, x, x),
        lambda: benchmarking.device_time_stats(torch.mm, x, x),
        lambda: profiling.profile_fn(torch.mm, x, x, log_dir=str(tmp_path / "p")),
        lambda: th.benchmark_model("Bilinear", 16, 8, 4),
        lambda: th.benchmark_large_img(32, 2, out_path=str(tmp_path / "l.json")),
        lambda: th.run_sweep("ratio", models=["Bilinear"], out_path=str(tmp_path / "s.json")),
        lambda: bench_cli.main(["--ratio", "--out", str(tmp_path / "c.json")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.trace(str(tmp_path / "q")):
            pass
