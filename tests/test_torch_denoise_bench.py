"""The denoising ablation's CLI (naf_torch.evals.denoise_bench) against the
JAX tool it ports (tools/run_denoising_bench.py), on the CPU: the same
command lines, and a short run that writes its JSON and nothing under
``benchmarks/`` or ``runs/``.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from naf_torch.evals import denoise_bench

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("run_denoising_bench",
                                                  REPO / "tools" / "run_denoising_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_command_lines_are_the_jax_tools():
    """``MODELS`` and ``COMMON`` equal the JAX tool's; a model's overrides
    are the JAX tool's with only ``run_dir`` moved out of ``runs/``."""
    tool = _jax_tool()
    assert denoise_bench.MODELS == tool.MODELS and denoise_bench.COMMON == tool.COMMON
    for name in tool.MODELS:
        jax_line = tool.MODELS[name] + tool.COMMON + [f"run_dir=runs/denoise_{name}"]
        port_line = [*denoise_bench.MODELS[name], *denoise_bench.COMMON,
                     f"run_dir={Path('build') / f'denoise_{name}'}"]
        assert port_line[:-1] == jax_line[:-1] and port_line[-1] != jax_line[-1]


def test_short_run_writes_the_json_and_nothing_under_benchmarks(tmp_path, monkeypatch, capsys):
    """NAF at the JAX tool's width (k 15, one head) for 2 steps at 32^2,
    batch 2, one validation batch, on the CPU, from the repository root as
    the JAX tool runs."""
    monkeypatch.chdir(REPO)
    before = {d: sorted((REPO / d).rglob("*")) for d in ("benchmarks", "runs")}
    out = tmp_path / "denoising.json"
    res = denoise_bench.main(["naf", "train_steps=2", "val_steps=1", "img_size=32",
                              "train_dataloader.batch_size=2", "device=cpu", f"out={out}"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    rec = res["models"]["naf"]
    assert set(res["models"]) == {"naf"} and res["card"] is None and res["tf32"] is False
    assert np.isfinite(rec["psnr"]) and 0 < rec["ssim"] <= 1 and rec["train_s"] > 0
    assert rec["overrides"][:len(denoise_bench.MODELS["naf"])] == denoise_bench.MODELS["naf"]
    assert f"run_dir={tmp_path / 'denoise_naf'}" in rec["overrides"]
    assert rec["train"]["photos"] == 60 and rec["val"]["photos"] == 9
    assert set(rec["launches"].values()) == {0}  # the CPU runs the plain versions
    assert (tmp_path / "denoise_naf" / "metrics.jsonl").exists()
    assert "naf: PSNR" in capsys.readouterr().out
    assert {d: sorted((REPO / d).rglob("*")) for d in ("benchmarks", "runs")} == before


@pytest.mark.parametrize("tf32", [False, True])
def test_bench_sets_and_records_its_own_tf32(tf32, tmp_path, monkeypatch):
    """Every model's run with cuDNN's and cuBLAS's TF32 as ``--tf32`` says
    (off without it), the JSON records it, and the caller's switches come
    back after it (the runs themselves stubbed)."""
    seen, caller = [], (not tf32, tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller[0])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller[1])
    switches = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def run(name, run_root, extra):
        seen.append(switches())
        return {"psnr": 20.0, "ssim": 0.5, "train_s": 1.0, "train": {"photos": 60},
                "launches": {}}

    monkeypatch.setattr(denoise_bench, "run_model", run)
    out = tmp_path / "d.json"
    res = denoise_bench.main(["ircnn", "rednet", "device=cpu", f"out={out}"]
                             + (["--tf32"] if tf32 else []))
    assert set(res["models"]) == {"ircnn", "rednet"}
    assert seen == [(tf32, tf32)] * 2 and switches() == caller
    assert res["tf32"] is tf32 and json.loads(out.read_text())["tf32"] is tf32
