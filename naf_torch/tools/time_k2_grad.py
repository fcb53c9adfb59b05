"""Time and peak memory of K2's gradient at NAF's 448^2 <- 28^2 shape in
bf16, for one checkout of the port or several in turn.

    python naf_torch/tools/time_k2_grad.py [TREE ...]

Each TREE (default: this checkout) is the root of a checkout whose
``naf_torch`` is timed, in a fresh process each, in the order given (for a
comparison on one card: parent, change, change, parent). The step and the
timers are ``chip_smoke.py``'s of this checkout (``k2_grad_step``,
``_kernel_ms``, ``_queued_ms``, ``_peak_mib``): K2's forward and the
backward through its differentiation twin (pool-up, RoPE, K3 and K4, and
their autograd); device time of every kernel and of K3 + K4 by
torch.profiler, the queued time, and the call's own peak memory, with the
card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
REPS = 10


def _one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from naf_torch.utils.benchmarking import card_line

    if not torch.cuda.is_available():
        raise SystemExit("time_k2_grad needs a CUDA device")
    dev = torch.device("cuda", 0)
    step = smoke.k2_grad_step(dev, torch.Generator(device=dev).manual_seed(11), 448)
    ms = smoke._kernel_ms(step, reps=REPS)
    k34 = smoke._kernel_ms(step, ("na_fwd", "na_bwd"), reps=REPS)
    queued = smoke._queued_ms(step, reps=REPS, spin=1_000_000_000)
    peak = smoke._peak_mib(step)
    print(f"{tree}: K2 gradient bf16 448^2 <- 28^2 x 384, 4 heads, k 9: kernels {ms:.4f} ms, "
          f"of them K3 + K4 {k34:.4f} ms (queued {queued:.4f} ms); call peak {peak:.1f} MiB "
          f"({card_line()})", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        _one(sys.argv[2])
        return 0
    for tree in sys.argv[1:] or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
