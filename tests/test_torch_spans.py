"""The port's spans and host-to-device copy counter (naf_torch.utils.spans)
on the CPU: nothing entered or kept while no profiler runs, the inference
path's spans and their nesting under ``torch.profiler``, their stamps on the
profiler's clock, the trainer's four ranges, ``to_device``'s counts, the
per-span breakdown of a profile (``spans.breakdown``), and source scans that keep every copy of a host array and every
``record_function`` inside the helper."""

import ast
import pathlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from naf_torch.api import load_naf_params, naf
from naf_torch.models.naf import NAF
from naf_torch.train.trainer import make_train_step
from naf_torch.utils import spans

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parents[1] / "naf_torch"
HELPER = PKG / "utils" / "spans.py"
INFERENCE = ["naf.encoder", "naf.keys", "naf.attention"]
TRAINER = ["naf.backbone", "naf.forward", "naf.backward", "naf.optimizer"]


@pytest.fixture(scope="module")
def small():
    model = load_naf_params(device="cpu", dim=32, heads_attn=2, heads_rope=2, kernel_size=3)
    gen = torch.Generator().manual_seed(0)
    image = torch.randn(1, 3, 32, 32, generator=gen)
    feats = torch.randn(1, 16, 4, 4, generator=gen)
    with profile(activities=[ProfilerActivity.CPU]):  # the first range of a process is slow
        with spans.span("warm-up"):
            pass
    spans.clear()
    return model, image, feats


def _profiled(fn):
    """fn() under a CPU profile: (its records, {name: [(start_ns, end_ns)]} of
    the profile's CPU events)."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    recs = spans.records()
    spans.clear()
    return recs, events


def test_off_enters_no_range_and_keeps_nothing(small, monkeypatch):
    model, image, feats = small

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = len(spans.records())
    out = naf(model, image, feats, (32, 32))
    assert out.shape == (1, 16, 32, 32) and len(spans.records()) == before
    assert spans.span("naf.call") is spans.span("naf.keys")  # one shared no-op


def test_one_forward_one_call_and_its_children(small):
    model, image, feats = small
    recs, _ = _profiled(lambda: naf(model, image, feats, (32, 32)))
    calls = [r for r in recs if r.name == "naf.call"]
    assert len(calls) == 1 and calls[0].parent is None
    children = [r for r in recs if r.parent is calls[0]]
    assert [r.name for r in children] == INFERENCE and len(recs) == 4
    assert all(r.end_ns is not None for r in recs)
    for a, b in zip(children, children[1:]):
        assert calls[0].start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns
    assert children[-1].end_ns <= calls[0].end_ns


def test_stamps_on_the_profilers_clock(small):
    """Each record's start and end within 1 ms of the profile's CPU event of
    the same name (the profiler's host clock is the Unix epoch)."""
    model, image, feats = small
    recs, events = _profiled(lambda: naf(model, image, feats, (32, 32)))
    for r in recs:
        (s, t), = events[r.name]
        assert abs(r.start_ns - s) < 1_000_000 and abs(r.end_ns - t) < 1_000_000, r


def test_banded_forward_one_attention_span_per_band(small):
    model, image, feats = small
    recs, _ = _profiled(lambda: model(image.permute(0, 2, 3, 1), feats.permute(0, 2, 3, 1),
                                      (32, 32), band_rows=16))
    assert [r.name for r in recs] == INFERENCE[:2] + ["naf.attention"] * 2
    assert all(r.parent is None for r in recs)  # the model called without the entry


def test_the_trainers_four_ranges():
    torch.manual_seed(0)
    model = NAF(dim=32, heads_attn=2, heads_rope=2, kernel_size=3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)

    def backbone(x):  # (B, H, W, 3) -> (B, H/8, W/8, 12)
        return x[:, ::8, ::8].repeat(1, 1, 1, 4)

    step = make_train_step(model, backbone, opt, use_bf16=False)
    image = torch.rand(1, 64, 64, 3)
    recs, events = _profiled(lambda: step(image, image, 0, (32, 32), (8, 8), (32, 32)))
    top = [r for r in recs if r.parent is None]
    assert [r.name for r in top] == TRAINER and all(n in events for n in TRAINER)
    enc = [r for r in recs if r.name == "naf.encoder"]
    assert len(enc) == 1 and enc[0].parent.name == "naf.forward"


def test_to_device_counts_copies_to_a_device():
    c0, b0 = spans.to_device.copies, spans.to_device.nbytes
    out = spans.to_device(np.arange(6, dtype=np.float32), "meta")
    assert out.device.type == "meta" and out.dtype == torch.float32
    assert (spans.to_device.copies - c0, spans.to_device.nbytes - b0) == (1, 24)
    half = spans.to_device(np.arange(6, dtype=np.float64), "meta", torch.float16)
    assert half.dtype == torch.float16
    assert (spans.to_device.copies - c0, spans.to_device.nbytes - b0) == (2, 36)
    a = np.arange(4, dtype=np.int64)
    cpu = spans.to_device(a, "cpu")
    assert cpu.data_ptr() == a.__array_interface__["data"][0]  # as from_numpy: shared
    spans.to_device(torch.ones(3), torch.device("cpu"), torch.float64)
    spans.to_device(out, "meta")  # already there
    assert (spans.to_device.copies - c0, spans.to_device.nbytes - b0) == (2, 36)


def test_copies_charged_to_the_innermost_span():
    def work():
        with spans.span("outer"):
            spans.to_device([1.0, 2.0], "meta")
            with spans.span("inner"):
                spans.to_device(np.zeros((2, 3), np.float32), "meta")
                spans.to_device(np.zeros(3, np.float32), "cpu")

    recs, _ = _profiled(work)
    assert [(r.name, r.copies, r.nbytes) for r in recs] == [("outer", 1, 8), ("inner", 1, 24)]
    assert recs[1].parent is recs[0] and recs[0].parent is None


class _Ev:
    """A kineto event of a synthetic profile, in us from 0."""

    def __init__(self, name, start_us, end_us, cuda=False, ann=False):
        self._n, self._s, self._d = name, start_us * 1000, (end_us - start_us) * 1000
        self._dev, self._ann = "CUDA" if cuda else "CPU", ann

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return types.SimpleNamespace(name=self._dev)

    def is_user_annotation(self):
        return self._ann


def test_breakdown_of_a_synthetic_profile():
    """One call in a window [0, 100] us: naf.call [5, 95] over naf.encoder
    [10, 40] and naf.attention [40, 90]; kernels [20, 30] (the encoder's),
    [35, 50] (launched under the encoder, past its end) and [60, 80] (the
    attention's), one before the window, clipped away."""
    recs = []
    for name, s, t, parent in (("naf.call", 5, 95, None), ("naf.encoder", 10, 40, 0),
                               ("naf.attention", 40, 90, 0)):
        recs.append(types.SimpleNamespace(id=len(recs), name=name, start_ns=s * 1000,
                                          end_ns=t * 1000,
                                          parent=None if parent is None else recs[parent]))
    events = [_Ev("k", -10, -5, cuda=True), _Ev("k", 20, 30, cuda=True),
              _Ev("k", 35, 50, cuda=True), _Ev("k", 60, 80, cuda=True),
              _Ev("naf.encoder", 20, 50, cuda=True, ann=True),
              _Ev("naf.attention", 60, 80, cuda=True, ann=True),
              _Ev("naf.encoder", 10, 40), _Ev("aten::copy_", 12, 13)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    got = spans.breakdown(prof, recs, 0, 100_000, 2)
    us = {n: {k: round(v * 2e3, 6) for k, v in row.items()} for n, row in got["spans"].items()}
    assert list(us) == ["naf.call", "naf.encoder", "naf.attention", "outside"]
    assert us["naf.call"] == {"device_ms": 0, "host_self_ms": 10, "idle_ms": 10}
    assert us["naf.encoder"] == {"device_ms": 25, "host_self_ms": 30, "idle_ms": 15}
    assert us["naf.attention"] == {"device_ms": 20, "host_self_ms": 50, "idle_ms": 20}
    assert us["outside"] == {"host_self_ms": 10, "idle_ms": 10}
    assert (got["window_ms"], got["busy_ms"]) == pytest.approx((0.05, 0.0225))


def _calls(path):
    yield from (n for n in ast.walk(ast.parse(path.read_text())) if isinstance(n, ast.Call))


def _name(f):
    return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)


def _host_copy(call) -> bool:
    """``torch.from_numpy(...)`` or ``torch.as_tensor(...)``, through indexing
    and method calls, then ``.to(...)``."""
    if _name(call.func) != "to" or not isinstance(call.func, ast.Attribute):
        return False
    node = call.func.value
    while True:
        if isinstance(node, ast.Call) and _name(node.func) in ("from_numpy", "as_tensor"):
            return True
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            node = node.func.value
        else:
            return False


def test_no_host_copy_outside_the_helper():
    found = [f"{p.relative_to(PKG.parent)}:{c.lineno}" for p in sorted(PKG.rglob("*.py"))
             if p != HELPER for c in _calls(p) if _host_copy(c)]
    assert found == [], found


def test_every_record_function_in_the_helper():
    found = []
    for p in sorted(PKG.rglob("*.py")):
        for n in ast.walk(ast.parse(p.read_text())):
            named = (n.attr if isinstance(n, ast.Attribute) else n.id if isinstance(n, ast.Name)
                     else None)
            if named == "record_function" or (isinstance(n, ast.alias)
                                              and n.name == "record_function"):
                found.append(str(p.relative_to(PKG.parent)))
    assert found and set(found) == {str(HELPER.relative_to(PKG.parent))}, found


def test_a_span_inside_one_of_its_name_adds_no_record():
    """The profiler gives a range the device time from its first kernel to
    its last, so a range nested in one of its own name would count the
    inner kernels twice (K3/K4's backward inside K2's): it is not opened."""
    def work():
        with spans.span("naf.attention.backward"):
            with spans.span("naf.attention.backward"):
                with spans.span("inner"):
                    pass
        with spans.span("naf.attention.backward"):
            pass

    recs, _ = _profiled(work)
    assert [r.name for r in recs] == ["naf.attention.backward", "inner",
                                      "naf.attention.backward"]
    assert recs[1].parent is recs[0] and recs[2].parent is None


def test_attention_backward_span_under_the_trainers_backward():
    """K3/K4's custom Function (the "pallas" attention runs its plain
    versions on the CPU) opens ``naf.attention.backward`` in its backward,
    nested under ``naf.backward``."""
    torch.manual_seed(0)
    model = NAF(dim=32, heads_attn=2, heads_rope=2, kernel_size=3, na_impl="pallas")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)

    def backbone(x):  # (B, H, W, 3) -> (B, H/8, W/8, 12)
        return x[:, ::8, ::8].repeat(1, 1, 1, 4)

    step = make_train_step(model, backbone, opt, use_bf16=False)
    image = torch.rand(1, 64, 64, 3)
    recs, events = _profiled(lambda: step(image, image, 0, (32, 32), (8, 8), (32, 32)))
    assert [r.name for r in recs if r.parent is None] == TRAINER
    back = [r for r in recs if r.name == "naf.attention.backward"]
    assert len(back) == 1 and back[0].parent.name == "naf.backward"
    assert "naf.attention.backward" in events
