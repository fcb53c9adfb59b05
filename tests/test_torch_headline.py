"""The headline bench (naf_torch.bench.headline) against the root bench.py
and naf_tpu, on the CPU at small sizes given through ``sizes``.

Held against the JAX side: the printed line's keys (read from bench.py by
``ast``: importing bench.py would set JAX's compilation cache), the inputs
(the same numpy draws in bench.py's order, and JAX's bf16 rounding of
them), each forward field's call on JAX's ``load_naf_params`` weights
carried across (f32 atol = rtol = 2e-4, bf16 cosine > 0.9995 to JAX's f32),
the bench step (bench.py's ``train_step`` restated, ``jax.grad`` and SGD
1e-3: the loss at rtol 2e-3, and each leaf's update, recovered as a gradient
on an f64 copy, within a relative 2-norm of 2e-3), the bare kernel with
dv != d against the Pallas kernel in interpret mode and ``naf_streamed``
against JAX's (2e-4). On the port alone: ``run``, ``--only`` and
``--stages`` at small sizes, the command's arguments and output, and that a
failing field exits non-zero.
"""

import ast
import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.api import naf_streamed
from naf_torch.bench import headline as h
from naf_torch.bench.harness import _train_step
from naf_torch.convert import state_dict_from_jax_params
from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
from naf_torch.models.naf import NAF
from naf_tpu.api import load_naf_params as j_load_naf_params
from naf_tpu.api import naf_streamed as j_naf_streamed
from naf_tpu.kernels.na2d_fused import cross_scale_na2d_fused as j_cross_scale_na2d_fused

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py's shapes cut to size: dim 128 (the JAX kernels' cell geometry
# wants 128 lanes), k 5 on 8^2 cells, dv 24 against d 16 at k 3; the streamed
# request at ratio 4 in 16-row bands (JAX's tile geometry takes whole image rows)
SMALL = dict(h.HEADLINE, image=(1, 64, 64, 3), feats=(1, 8, 8, 32), image2=(1, 64, 64, 3),
             feats2=(1, 16, 16, 32), q=(1, 32, 32, 4, 16), k=(1, 4, 4, 4, 16),
             v=(1, 4, 4, 4, 24), kernel=3, img512=(1, 32, 32, 3), feats4k=(1, 16, 16, 32),
             out=64, out2=128, out4k=64, band_rows=16,
             naf=dict(dim=128, heads_attn=4, heads_rope=4, kernel_size=5), canary=64)
QUICK = dict(iters=1, repeats=1, warmup=0)
# the forward fields: (guide, features, output side)
FORWARDS = {"naf_fwd_fps_448_r16_dim384": ("image", "feats", "out"),
            "fps_2048_r16": ("image2", "feats2", "out2"),
            "fps_448to2048_r16": ("image", "feats2", "out2")}


def _bench_py_line_keys():
    """The keys of bench.py's printed line: its ``line`` dict's, then the
    optional keys its loop adds, as (always, optional)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    line = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "line" for t in n.targets))
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For)
                and isinstance(n.iter, ast.Tuple))
    return [k.value for k in line.keys], [e.value for e in loop.iter.elts]


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def pair():
    """JAX's ``load_naf_params`` model and f32 weights, the port's NAF on
    them, and the inputs in f32."""
    jm, params = j_load_naf_params(**SMALL["naf"])
    model = NAF(**SMALL["naf"])
    model.load_state_dict(state_dict_from_jax_params(params, heads_rope=4))
    return jm, params, model.eval(), h.headline_inputs(SMALL, "cpu", torch.float32)


@pytest.fixture(scope="module")
def record():
    return h.run("cpu", SMALL, **QUICK)


def test_line_keys_are_bench_py_s(record):
    always, optional = _bench_py_line_keys()
    rec = record
    line = h.bench_line(rec)
    # bench.py's fps_4096_error has no counterpart: a failing field raises
    assert list(line) == always + ["fps_4096"] and optional == ["fps_4096", "fps_4096_error"]
    assert line["vs_baseline"] == round(rec["fields"]["naf_fwd_fps_448_r16_dim384"]["value"]
                                        / (1000.0 / 56.24), 2)


def test_inputs_are_bench_py_s_draws():
    rng = np.random.RandomState(0)
    c = SMALL["feats"][-1]
    want = {"image": rng.randn(*SMALL["image"]), "feats": rng.randn(*SMALL["feats"]),
            "head": rng.randn(c, c) * 0.01, "image2": rng.randn(*SMALL["image2"]),
            "feats2": rng.randn(*SMALL["feats2"]), "q": rng.randn(*SMALL["q"]),
            "k": rng.randn(*SMALL["k"]), "v": rng.randn(*SMALL["v"]),
            "img512": rng.randn(*SMALL["img512"]), "feats4k": rng.randn(*SMALL["feats4k"])}
    got = h.headline_inputs(SMALL, "cpu", torch.float64)
    assert list(got) == list(want)
    bf16 = h.headline_inputs(SMALL, "cpu")
    some = h.headline_inputs(SMALL, "cpu", torch.float64, names=("image", "feats2"))
    assert list(some) == ["image", "feats2"]
    for name, x in want.items():
        np.testing.assert_array_equal(got[name].numpy(), x)
        if name in some:
            np.testing.assert_array_equal(some[name].numpy(), x)
        assert bf16[name].dtype == torch.bfloat16
        # bench.py's jnp.asarray(x, jnp.bfloat16), bit for bit
        np.testing.assert_array_equal(bf16[name].float().numpy(),
                                      np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))


@pytest.mark.parametrize("field", list(FORWARDS))
def test_forward_matches_jax(pair, field):
    jm, params, model, x = pair
    img, feats, out = FORWARDS[field]
    size = (SMALL[out],) * 2
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x[img].numpy()),
                               jnp.asarray(x[feats].numpy()), size))
    got = h._forward(model, x[img], x[feats], size)
    assert got.shape == (1, *size, SMALL[feats][-1])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    got16 = h._forward(bf16, x[img].bfloat16(), x[feats].bfloat16(), size)
    assert got16.dtype == torch.bfloat16 and _cos(got16.float().numpy(), want) > 0.9995


def _rel(got, want):
    """The relative 2-norm of ``got - want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bench_step_matches_jax_grad(pair):
    """bench.py:82-89's ``train_step``, restated, against the headline's
    step (``harness._train_step``) from the same weights: the loss, and the
    update each leaf takes. The step runs on an f64 copy, so that
    (before - after) / lr recovers its gradient to ~1e-10; each leaf's and
    the head's gradient must lie within a relative 2-norm of 2e-3 of
    ``jax.grad``'s (a missing, sign-flipped or doubled update misses by 1
    or more)."""
    jm, params, model, x = pair
    size, lr = (SMALL["out"],) * 2, 1e-3
    image, feats = jnp.asarray(x["image"].numpy()), jnp.asarray(x["feats"].numpy())
    head = jnp.asarray(x["head"].numpy())

    def loss_fn(p, hd):
        out = jm.apply({"params": p}, image, feats, size)
        return jnp.mean((out @ hd) ** 2)

    want_loss, (gp, gh) = jax.value_and_grad(loss_fn, argnums=(0, 1))(params, head)
    m = copy.deepcopy(model).double()
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    hd = x["head"].double().requires_grad_()
    loss = _train_step(m, hd, x["image"].double(), x["feats"].double(), size, lr=lr)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=2e-3, atol=0)
    want = state_dict_from_jax_params(gp, heads_rope=4)  # with the constant periods
    assert set(want) - set(before) == {n for n, _ in m.named_buffers()}
    for name, p in m.named_parameters():
        got = (before[name] - p.detach()) / lr
        assert _rel(got.numpy(), want[name].numpy()) <= 2e-3, name
    assert _rel((x["head"].double() - hd.detach()).numpy() / lr, gh) <= 2e-3


def test_bare_kernel_matches_the_pallas_kernel(pair):
    x = pair[3]
    assert x["v"].shape[-1] != x["q"].shape[-1]  # dv 24 against d 16, as bench.py's 96 / 64
    want = j_cross_scale_na2d_fused(*(jnp.asarray(x[n].numpy()) for n in "qkv"),
                                    SMALL["kernel"], interpret=True)
    got = cross_scale_na2d_fused(x["q"], x["k"], x["v"], SMALL["kernel"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_naf_streamed_matches_jax(pair):
    jm, params, model, x = pair
    size = (SMALL["out4k"],) * 2
    want = j_naf_streamed(jm, params, jnp.asarray(x["img512"].numpy()),
                          jnp.asarray(x["feats4k"].numpy()), size,
                          band_rows=SMALL["band_rows"], interpret=True)
    got = naf_streamed(model, x["img512"], x["feats4k"], size, band_rows=SMALL["band_rows"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_run_gives_every_field(record):
    rec = record
    assert list(rec["fields"]) == list(h.FIELDS) and rec["tf32"] is False
    for name, res in rec["fields"].items():
        for key in ("ms", "ms_min", "ms_max", "value"):
            assert np.isfinite(res[key]) and res[key] > 0, (name, key, res)
        assert res["launches"] == {} and res["peak_mib"] is None  # the plain path, no card
    assert rec["card"] == "cpu" and set(rec["peak_mib_448"]) == {"forward", "backward"}
    assert h.expected_launches(SMALL)["fps_4096"] == {"k1": 8, "k2": 4}


def test_check_launches():
    """The launch check the card's test and chip_smoke.py share: K1-K4
    exactly as wanted, bf16 K2 and K3/K4 on the tensor-core route."""
    step = h.expected_launches(SMALL)["bwd_ms_448_r16"]
    good = {**step, "k2_wgmma": 1, "k34_wgmma": 1, "k34_wgmma_bwd": 1, "k6": 0}
    h.check_launches("step", good, step)
    for bad in ({**good, "k1": 7}, {**good, "k5": 1, "k3": 2},
                {**good, "k34_wgmma": 0, "k34_fma": 1}, {**good, "k2_wgmma": 0}):
        bad = {k: v for k, v in bad.items() if v}
        with pytest.raises(AssertionError, match="headline step"):
            h.check_launches("step", bad, step)


def test_only_and_stages(record):
    rec = h.run("cpu", SMALL, only="fps_448to2048_r16", **QUICK)
    assert list(rec["fields"]) == ["fps_448to2048_r16"] and "peak_mib_448" not in rec
    st = h.stages(device="cpu", sizes=SMALL, **QUICK)
    spans = st["spans"]
    assert list(spans) == [*h.STAGE_SPANS, "outside"] and st["launches"] == {}
    assert st["out"] == SMALL["out2"] and st["canary_ms"] > 0 and st["model_ms"] > 0
    assert st["busy_ms"] == 0 and all(v["device_ms"] == 0 for k, v in spans.items()
                                      if k != "outside")  # no device on the CPU
    host = [v["host_self_ms"] for v in spans.values()]
    assert all(v > 0 for v in host) and sum(host) == pytest.approx(st["window_ms"])
    assert sum(v["idle_ms"] for v in spans.values()) == pytest.approx(st["window_ms"])
    with pytest.raises(ValueError, match="no field"):
        h.run("cpu", SMALL, only="fps_448", **QUICK)


def test_cli(monkeypatch, capsys, record):
    """The command's arguments reach ``run`` and ``stages``; what it prints."""
    calls = []

    def fake_run(**kw):
        calls.append(("run", kw))
        only = kw["only"]
        return dict(record, fields={only: record["fields"][only]}) if only else record

    def fake_stages(out, **kw):
        calls.append(("stages", out, kw))
        return {"canary_ms": 1.0, "model_ms": 2.0,
                "spans": {"naf.call": {"device_ms": 1.5, "host_self_ms": 0.1, "idle_ms": 0.1},
                          "outside": {"host_self_ms": 0.2, "idle_ms": 0.2}}}

    monkeypatch.setattr(h, "run", fake_run)
    monkeypatch.setattr(h, "stages", fake_stages)
    assert h.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == json.loads(json.dumps(record))
    assert json.loads(lines[1]) == h.bench_line(record)
    assert h.main(["--device", "cpu", "--only"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert list(json.loads(lines[0])["fields"]) == ["fps_448to2048_r16"]
    assert lines[-1].startswith("fps_448to2048_r16 = ")
    assert h.main(["--stages", "--tf32"]) == 0 and h.main(["--stages", "896"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        "canary 1.000 ms; model 2.000 ms; naf.call device 1.500 host 0.100 idle 0.100; "
        "outside host 0.200 idle 0.200 ms a call")
    assert calls == [("run", dict(device="cpu", only=None, tf32=False)),
                     ("run", dict(device="cpu", only="fps_448to2048_r16", tf32=False)),
                     ("stages", None, dict(device="cuda", tf32=True)),
                     ("stages", 896, dict(device="cuda", tf32=False))]


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        h.main([])


def test_failing_field_exits_non_zero():
    """bench.py turns a failed fps_4096 into ``fps_4096_error``; the port's
    command exits non-zero and prints no line."""
    code = ("import json, sys, torch; torch.set_num_threads(1)\n"
            "from naf_torch.bench import headline as h\n"
            f"h.HEADLINE = json.loads({json.dumps(json.dumps(SMALL))})\n"
            "def boom(r): raise RuntimeError('the streamed field failed')\n"
            "h.FIELDS['fps_4096'] = boom\n"
            "sys.exit(h.main(['--device', 'cpu', '--only', 'fps_4096']))\n")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "the streamed field failed" in r.stderr
