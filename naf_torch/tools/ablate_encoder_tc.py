"""Where the bf16 encoder kernels' time goes: ablations of the tensor-core
core (``csrc/encoder_tc.cuh``) of K1 and K6.

    python -m naf_torch.tools.ablate_encoder_tc

Builds the K1 and K6 libraries once as they are and once per ablation, each
a text edit of the core (one ``nvcc`` per library, all started together, into
``build/naf_torch/tc_ablate/``), and times each kernel alone on its C entry
with CUDA events at the production layer: K1 3x3 and 1x1 at (1, 448, 448,
128), K6 at (1, 448, 448, 256) packed, bf16, in two rounds, the second in
reverse order. The ablations compute wrong values on purpose; only the
unedited build is checked against the plain versions (bf16 cosine > 0.9995).

- ``no_silu``: the halo is loaded but not activated;
- ``no_halo_load``: no cp.async of the halo (activation of stale data);
- ``no_weight_wait``: the weight stages are never loaded nor waited for;
- ``mma_only``: all three, leaving the wgmma loop, its syncs and the epilogue;
- ``m256``: a 16 x 16 tile (M = 256) for four warpgroups, one block per SM.

Prints ptxas registers and spill stores per kernel of each variant (in the
order ptxas compiles them) and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

_WAIT = ("    uint32_t done = 0;\n    do {", "    uint32_t done = 1;\n    if (!done) do {")
_NO_WEIGHTS = [("      for (int g = 0; g < STAGES && g < total; ++g) fetch(g);\n", ""), _WAIT,
               ("    if (threadIdx.x == 0 && g + STAGES < total) fetch(g + STAGES);", "")]
_NO_SILU = [("      *v = activate8(*v, s.sc + 8 * j, s.sh + 8 * j);\n", "")]
_NO_HALO = [("      cp_async16(s.tile_u32 + (p * cs + 8 * j) * 2,\n"
             "                 L.x + ((size_t)gy * W + gx) * L.xstride + c0 + 8 * j);\n", "")]
_M256 = [("constexpr int TH = 8; ", "constexpr int TH = 16;"),
         ("constexpr int THREADS = 256; ", "constexpr int THREADS = 512; "),
         ("__global__ void __launch_bounds__(THREADS, 2)", "__global__ void __launch_bounds__(THREADS, 1)")]
# the tile count of K1's and K6's C files, for M = 256
_M256_C = [('static_assert(TH == tc::TH && TW == tc::TW, "both kernels write the same per-tile '
            'partials");\n', ""),
           ("(H + TH - 1) / TH) * ((W + TW - 1) / TW)", "(H + tc::TH - 1) / tc::TH) * ((W + TW - 1) / TW)"),
           ("dim3 grid(((H + TH - 1) / TH) * tiles_w", "dim3 grid(((H + tc::TH - 1) / tc::TH) * tiles_w")]

VARIANTS = {
    "as_built": ([], []),
    "no_silu": (_NO_SILU, []),
    "no_halo_load": (_NO_HALO, []),
    "no_weight_wait": (_NO_WEIGHTS, []),
    "mma_only": (_NO_WEIGHTS + _NO_SILU + _NO_HALO, []),
    "m256": (_M256, _M256_C),
}


def _edit(text: str, edits, what: str) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{what} has no {old[:60]!r}: the ablation no longer applies")
        text = text.replace(old, new)
    return text


def _build_variants(out_dir):
    from naf_torch.kernels import _build

    procs = {}
    for name, (core_edits, c_edits) in VARIANTS.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "encoder_common.cuh").write_text((_build.CSRC / "encoder_common.cuh").read_text())
        (d / "encoder_tc.cuh").write_text(
            _edit((_build.CSRC / "encoder_tc.cuh").read_text(), core_edits, "encoder_tc.cuh"))
        for lib in ("encoder_fused", "encoder_dual"):
            src = (_build.CSRC / f"{lib}.cu").read_text()
            (d / f"{lib}.cu").write_text(_edit(src, c_edits, f"{lib}.cu") if c_edits else src)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / f"{lib}.so"),
                   str(d / f"{lib}.cu")]
            procs[(name, lib)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for (name, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{lib}.cu:\n{log}")
        print(f"{name} {lib}: registers {re.findall(r'Used (\d+) registers', log)}, spill "
              f"stores {re.findall(r'(\d+) bytes spill stores', log)}", flush=True)
        cdll = ctypes.CDLL(str(out_dir / name / f"{lib}.so"))
        if lib == "encoder_fused":
            cdll.naf_gn_silu_conv_tiles.argtypes = [i32, i32]
            cdll.naf_gn_silu_conv_tiles.restype = i32
            cdll.naf_gn_silu_conv_wgmma.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
            cdll.naf_gn_silu_conv_wgmma.restype = i32
        else:
            cdll.naf_gn_silu_conv_dual_tiles.argtypes = [i32, i32]
            cdll.naf_gn_silu_conv_dual_tiles.restype = i32
            cdll.naf_gn_silu_conv_dual_wgmma.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
            cdll.naf_gn_silu_conv_dual_wgmma.restype = i32
        libs[(name, lib)] = cdll
    return libs


def _time_ms(fn, iters: int = 30) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    import naf_torch.kernels.encoder_fused as ef
    from naf_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("ablate_encoder_tc needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    from naf_torch.utils.benchmarking import card_line

    card = card_line()
    print(card, flush=True)
    libs = _build_variants(_build.BUILD_DIR / "tc_ablate")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(15)
    h = w = 448
    c = 128
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.randn(1, h, w, 2 * c, generator=gen, device=dev)
    sc = torch.rand(1, 2 * c, generator=gen, device=dev) * 0.5 + 0.75
    sh = torch.randn(1, 2 * c, generator=gen, device=dev) * 0.1
    wts = {k: torch.randn(c, c, k, k, generator=gen, device=dev) * (k * k * c) ** -0.5
           for k in (1, 3)}
    bias = torch.randn(2 * c, generator=gen, device=dev) * 0.1
    xs = x[..., c:].contiguous()
    y_ref = {k: ef.gn_silu_conv_ref(xs, sc[:, c:], sh[:, c:], wts[k], bias[c:])[0] for k in (1, 3)}
    y6_ref = ef.gn_silu_conv_dual_ref(x, sc, sh, wts[1], wts[3], bias[:c], bias[c:])[0]
    xb, xsb = x.bfloat16(), xs.bfloat16()
    wk = {k: ef._packed((wts[k].bfloat16(),), 128, torch.bfloat16) for k in (1, 3)}
    wk6 = ef._packed((wts[1].bfloat16(), wts[3].bfloat16()), 128, torch.bfloat16)
    sc1, sh1, b1 = sc[:, c:].contiguous(), sh[:, c:].contiguous(), bias[c:].contiguous()
    out, out6 = torch.empty_like(xsb), torch.empty_like(xb)
    part = torch.empty(1, 28 * 56, 2, 2 * c, device=dev)  # holds the tiles of either tiling

    def k1(name, k):
        lib = libs[(name, "encoder_fused")]
        return lambda: lib.naf_gn_silu_conv_wgmma(
            xsb.data_ptr(), sc1.data_ptr(), sh1.data_ptr(), wk[k].data_ptr(), b1.data_ptr(),
            out.data_ptr(), part.data_ptr(), 1, h, w, c, c, k, 128, c, 0, stream)

    def k6(name):
        lib = libs[(name, "encoder_dual")]
        return lambda: lib.naf_gn_silu_conv_dual_wgmma(
            xb.data_ptr(), sc.data_ptr(), sh.data_ptr(), wk6.data_ptr(), bias.data_ptr(),
            out6.data_ptr(), part.data_ptr(), 1, h, w, c, 128, stream)

    def cos(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(a @ b / (a.norm() * b.norm()))

    for name in ("as_built", "m256"):  # the variants that compute the layer
        for k in (1, 3):
            k1(name, k)()
            torch.cuda.synchronize()
            if not cos(out.float(), y_ref[k]) > 0.9995:
                raise AssertionError(f"{name} K1 k={k} disagrees with the plain version")
        k6(name)()
        torch.cuda.synchronize()
        if not cos(out6.float(), y6_ref) > 0.9995:
            raise AssertionError(f"{name} K6 disagrees with the plain version")
    times = {name: {"K1 3x3": [], "K1 1x1": [], "K6": []} for name in VARIANTS}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            times[name]["K1 3x3"].append(_time_ms(k1(name, 3)))
            times[name]["K1 1x1"].append(_time_ms(k1(name, 1)))
            times[name]["K6"].append(_time_ms(k6(name)))
    for name, t in times.items():
        print(f"{name}: " + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in t.items())
              + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
