"""What the benchmark runs loads neither JAX nor the JAX package: a fresh
process drives both kinds at a tiny size on the CPU, then its modules are
compared by top-level name, whole."""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys
import torch
from h100bench import calibrate, run
from h100bench.tests.test_h100bench_reference import small_distill, small_upsample
import naf_torch.backbones.wrapper as wrapper

orig = wrapper.backbone_config
wrapper.backbone_config = lambda name: orig(name, num_heads=2, embed_dim=64, depth=1)
up = {"kind": "upsample", "batch": 1, "image": [16, 16], "features": [4, 4],
      "output": [16, 16], "distinct_inputs": 1, "checked_calls": 1}
dt = {"kind": "distill", "stack_images": 8, "checked_steps": 2, "chunk_steps": 1}
run.run_cell({"name": "a"}, small_upsample("bfloat16"), up, 1, 0.1, False, "cpu", limits={})
cfg = small_distill(use_bf16=True)
cfg["img_size"] = 56
run.run_cell({"name": "b"}, cfg, dt, 1, 0.1, False, "cpu", limits={})
print(json.dumps({"loaded": run.forbidden_modules(),
                  "naf_torch": sorted(m for m in sys.modules if m.split(".")[0] == "naf_torch")}))
"""


def test_no_jax_and_no_jax_package_in_a_run():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert "naf_torch.api" in res["naf_torch"] and "naf_torch.train.trainer" in res["naf_torch"]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from h100bench import run

    monkeypatch.setitem(sys.modules, "naf_tpu_lookalike", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert not {"naf_tpu_lookalike", "jaxtyping"} & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "naf_tpu.models", object())
    assert "naf_tpu" in run.forbidden_modules()


def test_the_harness_imports_no_jax_and_reads_nothing_of_benchmarks():
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|naf_tpu)\b", re.M)
    for p in (ROOT / "h100bench").rglob("*.py"):
        text = p.read_text()
        assert not imports.search(text), p
        assert re.search(r"(?<![A-Za-z0-9_])benchmarks/", text) is None or p.name == Path(
            __file__).name, p
