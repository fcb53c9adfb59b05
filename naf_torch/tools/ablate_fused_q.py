"""Where the bf16 K2's time goes: ablations of the tensor-core kernel of
``csrc/na2d_fused_q.cu`` and the core it shares with K3 (``csrc/na_tc.cuh``).

    python -m naf_torch.tools.ablate_fused_q

Builds the K2 library once as it is and once per ablation, each a text edit
of the two sources (one ``nvcc`` per variant, all started together, into
``build/naf_torch/fused_q_ablate/``), and times the kernel alone on its C
entry by its device time (calls queued behind a spinning kernel,
``chip_smoke.py``'s ``_queued_ms``; torch.profiler drops kernel records
across many profiles in one process) at NAF's main-path shapes, 448^2 -> 448^2 and 448^2 ->
2048^2 from a 448^2 x 256 encoder output and 28^2 x 384 features (4 heads,
k 9), bf16, in two rounds, the second in reverse order. The ablations
compute wrong values on purpose; only the unedited build is checked against
the plain version (bf16 cosine > 0.9995).

- ``no_prologue``: the query tile is left zero (no pool, RoPE or enc read);
- ``no_uniform``: every tile reads its window from the count tables per
  logit, as K3 does (no row of biases for the tiles whose queries share one
  window);
- ``all_uniform``: every tile takes the window of its first query as its
  row of biases (wrong windows where they differ): what the tiles would
  cost if all were uniform;
- ``no_softmax``: the logits go to P.V as they are (no window mask, no exp,
  no row sums);
- ``no_counts``: the window mask of the tiles that are not uniform reads no
  count tables (every box cell counts once);
- ``no_out``: no output rows are stored.

Prints ptxas registers and spill stores per kernel of each variant and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

from naf_torch.tools.ablate_na_tc import _NO_OUT, _NO_SOFTMAX, _edit, _smoke

_NO_PROLOGUE = [("    if (yl < g.Hq && x < g.Wq && c0 < src.d) {",
                 "    if (false && yl < g.Hq && x < g.Wq && c0 < src.d) {")]
_NO_UNIFORM = [("  if ((int)blockIdx.x < n_uniform)",
                "  if (false && (int)blockIdx.x < n_uniform)")]
_ALL_UNIFORM = [("  if ((int)blockIdx.x < n_uniform)", "  if (true)")]
_NO_COUNTS = [("          const int m = valid[half] && cell < ncell ? __ldg(hrow[half] + bi) * "
               "__ldg(wrow[half] + bj)\n                                                    : 0;",
               "          const int m = valid[half] && cell < ncell ? 1 : 0;")]

# {variant: {source file: edits}}
VARIANTS = {
    "as_built": {},
    "no_prologue": {"na2d_fused_q.cu": _NO_PROLOGUE},
    "no_uniform": {"na2d_fused_q.cu": _NO_UNIFORM},
    "all_uniform": {"na2d_fused_q.cu": _ALL_UNIFORM},
    "no_softmax": {"na_tc.cuh": _NO_SOFTMAX},
    "no_counts": {"na_tc.cuh": _NO_COUNTS},
    "no_out": {"na_tc.cuh": _NO_OUT},
}
FILES = ("na2d_fused_q.cu", "na_tc.cuh")
OUTPUTS = (448, 2048)


def edited_sources() -> dict:
    """{variant: {file: text}}; raises where an edit no longer applies."""
    from naf_torch.kernels import _build

    texts = {f: (_build.CSRC / f).read_text() for f in FILES}
    return {name: {f: _edit(texts[f], edits.get(f, []), f) for f in FILES}
            for name, edits in VARIANTS.items()}


def _build_variants(out_dir):
    from naf_torch.kernels import _build

    procs = {}
    for name, files in edited_sources().items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
               str(d / "na2d_fused_q.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        entries = re.findall(
            r"Compiling entry function '\w*?(fused_q\w*?_kernel)\w*?(?:ILi(\d+))?E", log)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: " + ", ".join(f"{k}<{nb or '-'}> {r} regs, {s} B spills"
                                      for (k, nb), r, s in zip(entries, regs, spills)),
              flush=True)
        cdll = ctypes.CDLL(str(out_dir / name / "lib.so"))
        cdll.naf_fused_q_wgmma.argtypes = [ptr] * 11 + [ctypes.c_float] + [i32] * 25 + [ptr]
        cdll.naf_fused_q_wgmma.restype = i32
        libs[name] = cdll
    return libs


def _call(dev, gen, stream, out, smoke):
    """Given a variant's library, a call of its K2 entry on bf16 inputs of
    the 448^2 -> out^2 request; and the inputs and output for the check."""
    import torch

    from naf_torch.kernels.na2d_fused_q import _plan_k2

    enc, keys, values, rt, ct, dh = smoke._k2_inputs(dev, gen, 448, out=out)
    eb, kb, vb = (t.bfloat16().contiguous() for t in (enc, keys, values))
    b, hi, wi, c = eb.shape
    _, hk, wk, cv = vb.shape
    n, ks = 4, 9
    d, dv = c // n, cv // n
    tqh, tqw, urh, urw, nb, *tables, n_uniform = _plan_k2(out, out, hk, wk, ks, d, dv, str(dev))
    o = torch.empty(b, out, out, cv, dtype=torch.bfloat16, device=dev)
    args = (eb.data_ptr(), kb.data_ptr(), vb.data_ptr(), rt.data_ptr(), ct.data_ptr(),
            *(t.data_ptr() for t in tables), o.data_ptr(), d ** -0.5,
            b, hi, wi, hi, 0, out, out, 0, out, out, 0, hk, wk, c, n, d, dv, dv, dh, tqh, tqw,
            urh, urw, nb, n_uniform, stream)

    def call(lib):
        return lambda: lib.naf_fused_q_wgmma(*args)

    # every tensor the pointers name stays referenced beside the call
    return call, (enc, keys, values, rt, ct, dh, o, eb, kb, vb, tables)


def main() -> int:
    import torch

    from naf_torch.kernels import _build
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention_ref
    from naf_torch.utils.benchmarking import card_line

    if not torch.cuda.is_available():
        raise SystemExit("ablate_fused_q needs a CUDA device")
    smoke = _smoke()
    card = card_line()
    print(card, flush=True)
    libs = _build_variants(_build.BUILD_DIR / "fused_q_ablate")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {out: _call(dev, gen, stream, out, smoke) for out in OUTPUTS}
    for out, (call, (enc, keys, values, rt, ct, dh, o, *_)) in calls.items():
        if call(libs["as_built"])():
            raise AssertionError(f"as_built launch failed at {out}^2")
        torch.cuda.synchronize()
        want = naf_upsample_attention_ref(enc, keys, values, rt, ct, dh, num_heads=4,
                                          kernel_size=9)
        c = smoke._cos(o.float(), want)
        if not c > 0.9995:
            raise AssertionError(f"as_built disagrees with the plain version at {out}^2: {c}")
        print(f"as_built 448^2 -> {out}^2: cos {c:.6f} to the f32 plain version", flush=True)
        del want
    times = {(name, out): [] for name in VARIANTS for out in OUTPUTS}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            for out, (call, _) in calls.items():
                times[(name, out)].append(
                    smoke._queued_ms(call(libs[name]), reps=10 if out == 448 else 3))
    for name in VARIANTS:
        print(f"{name}: " + "; ".join(
            f"K2 448^2 -> {out}^2 {times[(name, out)][0]:.4f} / {times[(name, out)][1]:.4f} ms"
            for out in OUTPUTS) + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
