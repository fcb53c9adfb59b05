"""Run one cell of the benchmark once:

    python3 -m h100bench --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``h100bench/configs/<config>.json``) and traffic mix
(``h100bench/traffic/<traffic>.json``); the mix's ``kind`` names the module
of ``h100bench/kinds/`` that drives the program, and each per-layer metric
is read by ``h100bench/metrics/<metric>.py``. With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
traced, and last ``checks``: each number compared with its limit). The
lines before it say what else a reader needs: the card, its power limit
and clocks, TF32, launches per kernel and route, calls and the window's
exact length. The numbers compared also close standard error.

Exit codes: 0 with a result; 2 bad arguments; 3 no CUDA card, or fewer
than the cell needs; 4 JAX or the JAX package loaded in this process.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "h100bench"
_T_IMPORT = time.time()

# Caches of the run's libraries live at fixed paths inside the checkout, so
# that only a checkout's first run builds; the port's kernels build into
# build/naf_torch/ by themselves. No library may load JAX through flax.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[_var] = str(ROOT / "build" / "h100bench" / _sub)
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

from h100bench import check, trace  # noqa: E402

__all__ = ["main", "run_cell", "load_cell", "process_start", "result_line", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "naf_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started, from /proc (10 ms
    ticks); the module's import time where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def load_cell(name: str, root: Path = ROOT):
    """(cell, config, traffic, manifest) of a cell of ``BENCHMARK.json``."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "h100bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic, manifest


def _for_cell(metrics, cell: str):
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"h100bench.metrics.{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class MetricContext:
    """What a per-layer metric's reader may read: the reduced trace, the
    calls (or steps) it covers, their host times, the work of one call
    (``{"k1": (FLOPs, bytes), "k2": ..., "flops": ...}``), the card, and
    ``window``: the unprofiled window that a kind runs before its profile
    (``{"calls", "images", "seconds"}``), or None."""

    def __init__(self, tr, calls, host_s, work, card, window=None):
        self.trace, self.calls, self.host_s, self.work, self.card = tr, calls, host_s, work, card
        self.window = window

    @staticmethod
    def patterns(metric: str):
        folder = HERE / "metrics" / f"{metric}.kernels"
        return [p.read_text().strip() for p in sorted(folder.glob("*.txt"))]


def card_info() -> dict:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return {"nvidia_smi": out.splitlines()[0] if out else ""}


def run_cell(cell, config, traffic, seed: int, seconds: float, traced: bool, device="cuda",
             limits=None, t_start=None) -> dict:
    """Drive one cell and judge it; returns the result's fields and the
    lines to print before it. ``limits`` defaults to the cell's file."""
    kind = importlib.import_module(f"h100bench.kinds.{traffic['kind']}")
    t_start = process_start() if t_start is None else t_start
    if torch.device(device).type == "cuda":  # set-up: the kernels built, TF32 as configured
        from naf_torch.kernels import _build

        _build.build()
        torch.backends.cudnn.allow_tf32 = config["tf32"]["cudnn"]
        torch.backends.cuda.matmul.allow_tf32 = config["tf32"]["matmul"]
    res = kind.run(config, traffic, seed, seconds, traced, device, t_start)
    limits = check.load_limits(cell["name"]) if limits is None else limits
    correct, checks = check.judge(res["numbers"], limits)
    res.update(correct=correct, checks=checks)
    return res


def result_line(res: dict, cell: dict, manifest: dict, traced: bool) -> dict:
    """The contract's object: the cell's metrics, in the manifest's units."""
    metrics = {}
    if traced:
        ctx = MetricContext(res["trace"], res["trace_calls"], res["host_s"], res["work"],
                            res["device"]["kind"], res.get("window"))
        for m in _for_cell(manifest["per_layer"], cell["name"]):
            value = _reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in _for_cell(manifest["end_to_end"], cell["name"]):
            metrics[m["name"]] = {"value": float(res["e2e"][m["name"]]), "unit": m["unit"]}
    out = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": res["device"]}
    if traced:
        out["breakdown"] = {"device_ops": res["trace"].device_ops(),
                            "idle_gaps": res["trace"].idle_gaps()}
    out["checks"] = res["checks"]
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    try:
        cell, config, traffic, manifest = load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"h100bench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: the cell needs {cell['chips']} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 3
    info = card_info()
    print(f"card: {info['nvidia_smi']}", flush=True)
    res = run_cell(cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    for line in res["lines"]:
        print(line, flush=True)
    loaded = forbidden_modules()
    if loaded:
        print(f"h100bench: this process loaded {', '.join(loaded)}; the benchmark runs the "
              "port alone", file=sys.stderr)
        return 4
    out = result_line(res, cell, manifest, bool(args.trace))
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
