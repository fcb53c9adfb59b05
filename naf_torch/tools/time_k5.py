"""Device time of K5 (FeatUp's spatially varying conv) at FeatUp's four
stages and at JBU's shape, f32, and of the two forwards that run it, for one
checkout of the port or several in turn.

    python naf_torch/tools/time_k5.py [TREE ...]

Each TREE (default: this checkout) is the root of a checkout whose
``naf_torch`` is timed, in a fresh process each, in the order given (for a
comparison on one card: parent, change, change, parent). Everything else is
``chip_smoke.py``'s of this checkout: ``_time_k5`` (per shape the kernel's
profiler device time, the queued time and the bound, the output held
against the plain version), then FeatUp (4 K5) and JBU (1 K5) through
``ModelWrapper`` with seeded random f32 weights on phase 7's inputs
(``_baseline_inputs``), 448^2 out: ms per forward by CUDA events over 10
forwards and the profiler's device time per forward of K5 and of every
other kernel (``_split_k5``). Every line carries the tree and the card's
name and power limit.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from naf_torch.models.registry import ModelWrapper
    from naf_torch.utils.benchmarking import card_line

    if not torch.cuda.is_available():
        raise SystemExit("time_k5 needs a CUDA device")
    dev = torch.device("cuda", 0)
    line = card_line()
    smoke._time_k5(dev, f"{tree}: {line}", smoke._peaks(line)[0])
    args = smoke._baseline_inputs(dev, torch.Generator(device=dev).manual_seed(7))
    for name in ("FeatUp", "JBU"):
        model = ModelWrapper(name, seed=0, device=dev)
        fwd = lambda: model(*args(name), (448, 448))
        ms = smoke._time_ms(fwd, iters=10)
        split = smoke._split_k5(fwd)
        print(f"{name} f32 448^2 forward {ms:.3f} ms; device time per forward: K5 "
              f"{split['k5']:.3f} ms ({split['k5_launches']:.0f} launches), other kernels "
              f"{split['other']:.3f} ms ({tree}: {line})", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        _one(sys.argv[2])
        return 0
    for tree in sys.argv[1:] or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
