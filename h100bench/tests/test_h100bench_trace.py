"""The trace reduction on a synthetic profile, the per-layer readers on it,
and the result line's keys."""

import json
import types
from pathlib import Path

import pytest

from h100bench import run, trace

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CARD = "NVIDIA H100 80GB HBM3"


class Ev:
    def __init__(self, name, start_us, dur_us, dev="CPU", ann=False):
        self._n, self._s, self._d = name, int(start_us * 1000), int(dur_us * 1000)
        self._dev, self._ann = dev, ann

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


def fake_profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


EVENTS = [
    Ev(trace.WINDOW, 0, 1000, ann=True),
    Ev("naf.backbone", 10, 300, ann=True),
    Ev("aten::conv2d", 20, 100),
    Ev("cudaLaunchKernel", 21, 5),
    Ev("aten::item", 600, 300),
    Ev("naf.backbone", 100, 250, dev="CUDA", ann=True),
    Ev("void gn_silu_conv_wgmma_kernel<3>(args)", 100, 100, dev="CUDA"),
    Ev("void fused_q_wgmma_kernel<96>(args)", 150, 150, dev="CUDA"),  # overlaps the first
    Ev("Memset (Device)", 320, 30, dev="CUDA"),
    Ev("void fused_q_kernel(args)", 900, 200, dev="CUDA"),  # cut at the window's end
]


def test_reduce_profile_busy_gaps_ranges():
    tr = trace.reduce_profile(fake_profile(EVENTS))
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx((200 + 30 + 100) * 1e-6)
    assert tr.ranges_us == {"naf.backbone": pytest.approx(280)}
    assert tr.kernel_s(["fused_q_wgmma_kernel"]) == pytest.approx(150e-6)
    assert tr.kernel_s(["fused_q_kernel"]) == pytest.approx(100e-6)
    assert tr.kernel_s(["gn_silu_conv_kernel"]) == 0
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(550e-6)  # 350 -> 900 is under aten::item
    assert gaps["aten::conv2d"] == pytest.approx(100e-6)  # 0 -> 100 at its midpoint 50
    assert tr.device_ops()[0][0].startswith("void fused_q_wgmma_kernel")


def test_reduce_profile_without_device_records_fails():
    with pytest.raises(RuntimeError, match="without device records"):
        trace.reduce_profile(fake_profile(EVENTS[:5]))


def test_readers_and_result_line_keys():
    tr = trace.reduce_profile(fake_profile(EVENTS))
    res = {
        "correct": True, "attempted": 2, "failed": 0, "trace": tr, "trace_calls": 2,
        "host_s": [1e-4, 3e-4], "work": {"k1": (1e6, 1e6), "k2": (2e6, 3e6), "flops": 1e9},
        "device": {"platform": "gpu", "kind": CARD, "count": 1, "memory_peak_bytes": 1,
                   "busy_s": tr.busy_s, "window_s": tr.window_s},
        "checks": {"rel_l2": {"value": 1e-3, "limit": 2e-3}},
        "e2e": {"img_per_s": 10.0, "latency_p95_ms": 5.0, "peak_mib": 1.0, "setup_s": 3.0},
        "window": {"calls": 2, "images": 8, "seconds": 0.5},
    }
    for cell in [w["name"] for w in MANIFEST["workloads"]]:
        for traced in (False, True):
            out = run.result_line(res, {"name": cell}, MANIFEST, traced)
            keys = ["correct", "attempted", "failed", "metrics", "device"]
            assert list(out) == keys + (["breakdown"] if traced else []) + ["checks"]
            assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
            if traced:
                assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
                assert len(out["breakdown"]["device_ops"]) <= 10
                # a quantity split by the cells' end-to-end metrics reads alike in each
                m = {n.split(".")[0]: v for n, v in out["metrics"].items()}
                assert m["host_ms_per_call"]["value"] == pytest.approx(0.2)
                assert m["kernels_per_call"]["value"] == pytest.approx(2.0)
                assert 0 < m["mfu_pct"]["value"] < 100
                assert m["device_idle_pct"]["value"] == pytest.approx(67.0)
                if "img_per_s.train" in out["metrics"]:
                    assert m["img_per_s"]["value"] == pytest.approx(16.0)
            else:
                assert "setup_s" in out["metrics"]


def test_a_reader_with_nothing_to_read_is_left_out():
    events = [e for e in EVENTS if "gn_silu" not in e.name()]
    tr = trace.reduce_profile(fake_profile(events))
    ctx = run.MetricContext(tr, 1, [1e-3], {"k1": (1e6, 1e6), "flops": 1e9}, CARD)
    assert run._reader("k1_roofline")(ctx) is None
    assert run._reader("backbone_ms")(ctx) is not None
    ctx = run.MetricContext(tr, 1, [1e-3], {}, CARD)
    assert run._reader("k2_roofline")(ctx) is None and run._reader("mfu_pct")(ctx) is None
    assert run._reader("img_per_s.train")(ctx) is None  # no unprofiled window
    assert run._reader("mfu_pct.train")(ctx) is None
