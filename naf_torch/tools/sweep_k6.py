"""Sweep K6's constants: output channels per warp (FW), input channels per
shared-memory stage (CB) and blocks per SM (MIN_BLOCKS).

    python -m naf_torch.tools.sweep_k6

Builds one variant of ``csrc/encoder_dual.cu`` per setting (one ``nvcc``
each, all started together, into ``build/naf_torch/k6_sweep/``), checks each
against K6's plain version in f32 (2e-4) at the production layer (1, 448,
448, 256) packed, C = 128 per stack, and times it in bf16 with CUDA events
in two rounds, the second in reverse order, beside the K1 1x1 + 3x3 pair on
the same halves. The constants shape K6's CUDA-core kernel, which runs f32
(bf16 runs the tensor-core kernel), so the variants are timed in f32. Prints
ptxas registers and spill stores per variant and the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

VARIANTS = {  # name: (FW, CB, MIN_BLOCKS)
    "fw16_cb16_mb2": (16, 16, 2), "fw16_cb16_mb1": (16, 16, 1), "fw8_cb16_mb3": (8, 16, 3),
    "fw8_cb16_mb2": (8, 16, 2), "fw8_cb8_mb3": (8, 8, 3), "fw16_cb8_mb2": (16, 8, 2),
}


def _variant_source(src: str, fw: int, cb: int, mb: int) -> str:
    for name, val in (("FW", fw), ("CB", cb), ("MIN_BLOCKS", mb)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {val};", src)
        if n != 1:
            raise RuntimeError(f"encoder_dual.cu has no single constant {name}")
    return src


def _build_variants(out_dir):
    from naf_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    src = (_build.CSRC / "encoder_dual.cu").read_text()
    procs = {}
    for name, consts in VARIANTS.items():
        (out_dir / f"{name}.cu").write_text(_variant_source(src, *consts))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers {regs}, spill stores {spills}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.naf_gn_silu_conv_dual_tiles.argtypes = [i32, i32]
        lib.naf_gn_silu_conv_dual_tiles.restype = i32
        lib.naf_gn_silu_conv_dual_fma.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.naf_gn_silu_conv_dual_fma.restype = i32
        libs[name] = lib
    return libs


def _time_ms(fn, iters: int = 20) -> float:
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
        raise SystemExit("sweep_k6 needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    from naf_torch.utils.benchmarking import card_line

    card = card_line()
    print(card, flush=True)
    libs = _build_variants(_build.BUILD_DIR / "k6_sweep")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(14)
    c = 128
    x = torch.randn(1, 448, 448, 2 * c, generator=gen, device=dev)
    sc = torch.rand(1, 2 * c, generator=gen, device=dev) * 0.5 + 0.75
    sh = torch.randn(1, 2 * c, generator=gen, device=dev) * 0.1
    wp = torch.randn(c, c, 1, 1, generator=gen, device=dev) * c ** -0.5
    ws = torch.randn(c, c, 3, 3, generator=gen, device=dev) * (9 * c) ** -0.5
    bp = torch.randn(c, generator=gen, device=dev) * 0.1
    bs = torch.randn(c, generator=gen, device=dev) * 0.1
    y_ref, _ = ef.gn_silu_conv_dual_ref(x, sc, sh, wp, ws, bp, bs)
    times = {name: [] for name in libs}
    built = ef._dual_lib
    try:
        for rnd, order in enumerate((list(libs), list(libs)[::-1])):
            for name in order:
                ef._dual_lib = (lambda lib: (lambda: lib))(libs[name])
                if rnd == 0:
                    y, _ = ef.gn_silu_conv_dual_fused(x, sc, sh, wp, ws, bp, bs)
                    err = (y - y_ref).abs().max().item()
                    if not torch.allclose(y, y_ref, atol=2e-4, rtol=2e-4):
                        raise AssertionError(f"variant {name}: f32 max_abs_err {err:.3e}")
                times[name].append(_time_ms(
                    lambda: ef.gn_silu_conv_dual_fused(x, sc, sh, wp, ws, bp, bs)))
    finally:
        ef._dual_lib = built
    xp, xs = x[..., :c].contiguous(), x[..., c:].contiguous()
    pair = _time_ms(lambda: (ef.gn_silu_conv_fused(xp, sc[:, :c], sh[:, :c], wp, bp),
                             ef.gn_silu_conv_fused(xs, sc[:, c:], sh[:, c:], ws, bs)))
    for name, t in times.items():
        print(f"K6 variant {name} (FW, CB, MIN_BLOCKS = {VARIANTS[name]}): f32 "
              f"{t[0]:.4f} / {t[1]:.4f} ms", flush=True)
    print(f"K1 1x1 + 3x3 pair on the halves, f32: {pair:.4f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
