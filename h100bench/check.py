"""How ``correct`` is decided: the numbers compared, their limits, and the
control's precision.

Each cell compares a few numbers with limits of its own, kept in
``h100bench/limits/<cell>.json`` as ``{"number": {"limit": x, "lower": a,
"upper": b}}``: the limit and the two readings it was set from (the
highest of sound runs of the program, the lowest of the control or of a
planted fault). A cell without a limit file, or a number without a limit,
is never correct. ``fp8`` is the control's rounding: the nearest precision
below the bf16 the configurations state, float8 e4m3 with a per-tensor
scale, as an fp8 path would store a tensor.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

__all__ = ["fp8", "rel_l2", "max_err", "leaf_gap", "load_limits", "judge", "HERE"]

HERE = Path(__file__).resolve().parent
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with a per-tensor scale, back in
    its own dtype; the gradient passes straight through."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


def _chunks(a: torch.Tensor, b: torch.Tensor, n: int = 1 << 26):
    a, b = a.reshape(-1), b.reshape(-1)
    for i in range(0, a.numel(), n):
        yield a[i:i + n].double(), b[i:i + n].double()


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    """||out - ref|| / ||ref||, in float64, a chunk at a time."""
    num = den = 0.0
    for x, y in _chunks(out, ref):
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return (num / den) ** 0.5


def max_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |out - ref| over the largest |ref|."""
    err = top = 0.0
    for x, y in _chunks(out, ref):
        err = max(err, float((x - y).abs().max()))
        top = max(top, float(y.abs().max()))
    return err / top


def leaf_gap(prog: dict, ref: dict, floor: float = 1e-3):
    """The worst leaf's gap between the program's norm and the reference's,
    | ||p|| - ||r|| |, over the larger of the reference leaf's norm and the
    median leaf's. Leaves whose reference norm is below ``floor`` times the
    median's (nought to rounding) are left out. Returns (gap, leaf, kept)."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    worst, leaf, kept = 0.0, None, 0
    for k, r in norms.items():
        if r < floor * med:
            continue
        kept += 1
        gap = abs(float(prog[k].double().norm()) - r) / max(r, med)
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf, kept


def load_limits(cell: str, root: Path = HERE) -> dict:
    path = root / "limits" / f"{cell}.json"
    if not path.exists():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text()).items()}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and at most its limit, and every limit has its number."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = bool(limits) and all(
        c["limit"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values()) and set(limits) <= set(numbers)
    return ok, checks
