"""Where the bf16 attention kernels' time goes: ablations of the tensor-core
core (``csrc/na_tc.cuh``) of K3 and K4.

    python -m naf_torch.tools.ablate_na_tc [--against TREE]

Builds the K3/K4 library once as it is and once per ablation, each a text
edit of the core (one ``nvcc`` per variant, all started together, into
``build/naf_torch/na_ablate/``), and with ``--against`` once more from the
unedited sources of another checkout rooted at TREE (variant ``against``:
e.g. the parent commit unpacked with ``git archive``, so that both are
timed in one process on one card; its C entries must take this checkout's
arguments, K3's ``lse`` pointer included), and times each kernel alone on its C entry
by its device time (torch.profiler, ``chip_smoke.py``'s ``_kernel_ms``) at
the training shape (4, 32^2 <- 16^2, 4 heads, d 64, dv 192) and at 448^2 <-
28^2 (d 64, dv 96), k 9, bf16, in two rounds, the second in reverse order.
K4's time includes its reduce pass, which the ``no_tile`` variant (tile
kernels that return at once) times nearly alone. The ablations compute
wrong values on purpose; only the unedited builds are checked against the
plain versions (bf16 cosine > 0.9995).

- ``no_pt``: K4 writes no P^T / dS^T tile from its registers (stmatrix);
- ``no_partials``: K4 computes its box products but stores no partials;
- ``no_out``: K3 stores no output rows, K4 no dq rows;
- ``no_softmax``: the logits go to P.V as they are (no window mask, no
  exp, no row sums);
- ``no_tile``: the tile kernels return at once (launch and reduce only).

Prints ptxas registers and spill stores per kernel of each variant and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import subprocess
from pathlib import Path

_NO_PT = [('"stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\\n"',
           '"// no stmatrix %0 %1 %2 %3 %4\\n"')]
_NO_PARTIALS = [("    if (cell >= ncell) continue;\n    float* row = part",
                 "    if (cell >= 0) continue;\n    float* row = part")]
_NO_OUT = [("    if (p < 0) continue;\n    bf16* row = dst + (p * g.n + t.h) * ch + c0;",
            "    if (p >= -1) continue;\n    bf16* row = dst + (p * g.n + t.h) * ch + c0;")]
_NO_SOFTMAX = [("  float mx[2];\n  if constexpr (UNIFORM)",
                "  if (g.n > 0) return;\n  float mx[2];\n  if constexpr (UNIFORM)")]
_NO_TILE = [("  extern __shared__ __align__(16) unsigned char smem_raw[];\n  const uint32_t raw_u",
             "  if (g.n > 0) return;\n  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
             "  const uint32_t raw_u")]

VARIANTS = {
    "as_built": [],
    "no_pt": _NO_PT,
    "no_partials": _NO_PARTIALS,
    "no_out": _NO_OUT,
    "no_softmax": _NO_SOFTMAX,
    "no_tile": _NO_TILE,
}
# (B, Hq, hk, heads, d, dv) at k = 9
SHAPES = {"train": (4, 32, 16, 4, 64, 192), "448": (1, 448, 28, 4, 64, 96)}


def _edit(text: str, edits, what: str) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{what} has no {old[:60]!r}: the ablation no longer applies")
        text = text.replace(old, new)
    return text


def edited_sources() -> dict:
    """{variant: na_tc.cuh text}; raises where an edit no longer applies."""
    from naf_torch.kernels import _build

    core = (_build.CSRC / "na_tc.cuh").read_text()
    return {name: _edit(core, edits, "na_tc.cuh") for name, edits in VARIANTS.items()}


def _build_variants(out_dir, against=None):
    from naf_torch.kernels import _build

    cu = (_build.CSRC / "na2d_fused.cu").read_text()
    sources = {name: (core, cu) for name, core in edited_sources().items()}
    if against is not None:
        csrc = Path(against) / "naf_torch" / "kernels" / "csrc"
        sources["against"] = ((csrc / "na_tc.cuh").read_text(),
                              (csrc / "na2d_fused.cu").read_text())
    procs = {}
    for name, (core, text) in sources.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "na_tc.cuh").write_text(core)
        (d / "na2d_fused.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
               str(d / "na2d_fused.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        entries = re.findall(r"Compiling entry function '\w*?(na_\w+?_kernel)\w*?(?:ILi(\d+))?E", log)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: " + ", ".join(f"{k}<{nb}> {r} regs, {s} B spills" for (k, nb), r, s in
                                      zip(entries, regs, spills) if nb), flush=True)
        cdll = ctypes.CDLL(str(out_dir / name / "lib.so"))
        cdll.naf_na_fwd_wgmma.argtypes = [ptr] * 9 + [f32] + [i32] * 13 + [ptr]
        cdll.naf_na_bwd_wgmma.argtypes = [ptr] * 12 + [f32] + [i32] * 14 + [ptr]
        cdll.naf_na_fwd_wgmma.restype = cdll.naf_na_bwd_wgmma.restype = i32
        libs[name] = cdll
    return libs


def _smoke():
    """This checkout's chip_smoke.py, whose timers the tool shares."""
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _calls(dev, gen, stream, shape, na):
    """(fwd, bwd): given a variant's library, a call of its K3 / K4 entry on
    bf16 inputs of ``shape``; the unedited build is checked first."""
    import torch

    b, hq, hk, n, d, dv = shape
    q, k, v, g = (torch.randn(b, h, h, n, c, generator=gen, device=dev)
                  for h, c in ((hq, d), (hk, d), (hk, dv), (hq, dv)))
    qb, kb, vb, gb = (t.bfloat16() for t in (q, k, v, g))
    sc = d ** -0.5
    pf = na._plan_tc(hq, hq, hk, hk, 9, d, dv, False, str(dev))
    pb = na._plan_tc(hq, hq, hk, hk, 9, d, dv, True, str(dev))
    tiles = -(-hq // pb[0]) * -(-hq // pb[1])
    out = vb.new_empty(b, hq, hq, n, dv)
    dq, dk, dvv = torch.empty_like(qb), torch.empty_like(kb), torch.empty_like(vb)
    part = torch.empty(b, tiles, n, pb[2] * pb[3], d + dv, device=dev)
    geo = (b, hq, hq, hk, hk, n, d, dv)

    def fwd(lib):
        tqh, tqw, urh, urw, nb, ch, cw, rl, cl = pf
        return lambda: lib.naf_na_fwd_wgmma(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), ch.data_ptr(), cw.data_ptr(),
            rl.data_ptr(), cl.data_ptr(), out.data_ptr(), None, sc, *geo, tqh, tqw, urh, urw,
            nb, stream)

    def bwd(lib):
        tqh, tqw, urh, urw, nb, ch, cw, rl, cl = pb
        return lambda: lib.naf_na_bwd_wgmma(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), gb.data_ptr(), ch.data_ptr(),
            cw.data_ptr(), rl.data_ptr(), cl.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dvv.data_ptr(), part.data_ptr(), sc, *geo, tqh, tqw, urh, urw, nb, 0, stream)

    return fwd, bwd, (q, k, v, g, out, (dq, dk, dvv))


def main(argv=None) -> int:
    import torch

    from naf_torch.kernels import _build
    from naf_torch.kernels import na2d_fused as na

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", metavar="TREE",
                        help="also time the unedited kernels of the checkout rooted at TREE")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_na_tc needs a CUDA device")
    from naf_torch.utils.benchmarking import card_line

    card = card_line()
    print(card, flush=True)
    libs = _build_variants(_build.BUILD_DIR / "na_ablate", args.against)
    checked = [name for name in ("as_built", "against") if name in libs]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(16)
    stream = torch.cuda.current_stream().cuda_stream

    def cos(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(a @ b / (a.norm() * b.norm()))

    device_ms = _smoke()._kernel_ms  # every kernel's device time, torch.profiler
    calls = {label: _calls(dev, gen, stream, shape, na) for label, shape in SHAPES.items()}
    for label, (fwd, bwd, (q, k, v, g, out, grads)) in calls.items():
        want = na.cross_scale_na2d_fused_ref(q, k, v, 9)
        want_g = na.cross_scale_na2d_fused_bwd_ref(q, k, v, g, 9)
        for name in checked:
            fwd(libs[name])()
            bwd(libs[name])()
            torch.cuda.synchronize()
            if not (cos(out.float(), want) > 0.9995
                    and all(cos(a.float(), w) > 0.9995 for a, w in zip(grads, want_g))):
                raise AssertionError(f"{name} disagrees with the plain versions at {label}")
    times = {(name, label, kern): [] for name in libs for label in SHAPES
             for kern in ("K3", "K4")}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for label, (fwd, bwd, _) in calls.items():
                times[(name, label, "K3")].append(device_ms(fwd(libs[name])))
                times[(name, label, "K4")].append(device_ms(bwd(libs[name])))
    for name in libs:
        print(f"{name}: " + "; ".join(
            f"{kern} {label} {times[(name, label, kern)][0]:.4f} / "
            f"{times[(name, label, kern)][1]:.4f} ms" for label in SHAPES for kern in ("K3", "K4"))
            + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
