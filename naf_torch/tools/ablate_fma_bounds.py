"""The launch bounds of the chunked f32 attention kernels (``fma_chunked``:
``fused_q_chunked_kernel`` of K2, ``na_fwd_chunked_kernel`` and
``na_bwd_chunked_kernel`` of K3 / K4), timed against each other.

    python -m naf_torch.tools.ablate_fma_bounds

Builds ``na2d_fused.cu`` and ``na2d_fused_q.cu`` once as they are
(``__launch_bounds__(THREADS, 1)``: one block per SM, the registers that
block may take) and once per variant, a text edit of the three kernels'
bounds (``default``: ``__launch_bounds__(THREADS)``, ptxas's own choice of
64 registers; ``two_blocks``: ``(THREADS, 2)``), one ``nvcc`` per library,
all started together, into ``build/naf_torch/fma_bounds/``. Each variant's
output must equal the unedited build's bit for bit. Then times K2, K3 and
K4 at the denoiser's attention in f32 (batch 2, 448^2, one head, d 256, dv
3, k 15, ratio 1: ``chip_smoke.py``'s inputs) through the wrappers, each
variant's libraries in their place, by device time (torch.profiler,
``chip_smoke.py``'s ``_kernel_ms``; K4 with its reduce pass), in two
rounds, the second in reverse order. Prints ptxas's registers and spills
per kernel and variant, and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import re
import subprocess
from pathlib import Path

KERNELS = ("na_fwd_chunked_kernel", "na_bwd_chunked_kernel", "fused_q_chunked_kernel")
VARIANTS = {"as_built": None, "default": "(THREADS)", "two_blocks": "(THREADS, 2)"}
SOURCES = ("na2d_fused", "na2d_fused_q")


def edited_sources() -> dict:
    """{variant: {source name: text}}; raises where the kernels' bounds are
    no longer ``__launch_bounds__(THREADS, 1)``."""
    from naf_torch.kernels import _build

    texts = {name: (_build.CSRC / f"{name}.cu").read_text() for name in SOURCES}
    found = {k: sum(f"__launch_bounds__(THREADS, 1)\n{k}(" in t for t in texts.values())
             for k in KERNELS}
    if found != dict.fromkeys(KERNELS, 1):
        raise RuntimeError(f"the chunked kernels' bounds moved: {found}")
    out = {}
    for variant, bounds in VARIANTS.items():
        out[variant] = {}
        for name, text in texts.items():
            for k in KERNELS:
                if bounds is not None:
                    text = text.replace(f"__launch_bounds__(THREADS, 1)\n{k}(",
                                        f"__launch_bounds__{bounds}\n{k}(")
            out[variant][name] = text
    return out


def _build_variants(out_dir: Path) -> dict:
    from naf_torch.kernels import _build

    procs = {}
    for variant, texts in edited_sources().items():
        d = out_dir / variant
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        for name, text in texts.items():
            (d / f"{name}.cu").write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                   str(d / f"{name}.so"), str(d / f"{name}.cu")]
            procs[(variant, name)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)
    for (variant, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant} {name}:\n{log}")
        for m in re.finditer(r"Function properties for \w*?(na_fwd_chunked|na_bwd_chunked|"
                             r"fused_q_chunked)\w*\n\s*(.*?)\n.*?Used (\d+) registers", log):
            print(f"{variant} {m.group(1)}: {m.group(3)} registers, {m.group(2).strip()}",
                  flush=True)
    return {variant: {name: out_dir / variant / f"{name}.so" for name in SOURCES}
            for variant in VARIANTS}


@contextlib.contextmanager
def _libraries(paths: dict):
    """The wrappers of K2 and K3/K4 on the libraries at ``paths``."""
    from naf_torch.kernels import _build
    from naf_torch.kernels import na2d_fused as na
    from naf_torch.kernels import na2d_fused_q as nq

    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(paths[name]))
    try:
        libs = {na: na._lib.__wrapped__(), nq: nq._lib.__wrapped__()}
    finally:
        _build.load = load
    saved = {mod: mod._lib for mod in libs}
    for mod, lib in libs.items():
        mod._lib = lambda lib=lib: lib
    try:
        yield
    finally:
        for mod, fn in saved.items():
            mod._lib = fn


def _smoke():
    """This checkout's chip_smoke.py, whose inputs and timers the tool
    shares."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main() -> int:
    import torch

    from naf_torch.kernels import _build
    from naf_torch.kernels import na2d_fused as na
    from naf_torch.kernels import na2d_fused_q as nq

    if not torch.cuda.is_available():
        raise SystemExit("ablate_fma_bounds needs a CUDA device")
    smoke = _smoke()
    dev, card = smoke._setup()
    print(card, flush=True)
    paths = _build_variants(_build.BUILD_DIR / "fma_bounds")
    gen = torch.Generator(device=dev).manual_seed(13)
    (enc, keys, values, rt, ct, dh), (q, k, v, g) = smoke._denoise_attention_inputs(dev, gen, 2)
    ks, sc = smoke.DENOISE_K, 256 ** -0.5
    calls = {
        "K2": (lambda: nq.naf_upsample_attention(enc, keys, values, rt, ct, dh, num_heads=1,
                                                 kernel_size=ks), "fused_q_chunked_kernel"),
        "K3": (lambda: na._launch_fwd(q, k, v, ks, sc), "na_fwd_chunked_kernel"),
        "K4": (lambda: na._launch_bwd(q, k, v, g, ks, sc),
               ("na_bwd_chunked_kernel", "na_bwd_reduce")),
    }
    first = {}
    times = {(variant, kern): [] for variant in VARIANTS for kern in calls}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for variant in order:
            with _libraries(paths[variant]):
                for kern, (fn, match) in calls.items():
                    out = fn()
                    out = torch.cat([t.flatten() for t in (out if isinstance(out, tuple)
                                                           else (out,))])
                    if kern not in first:
                        first[kern] = out
                    elif not torch.equal(out, first[kern]):
                        raise AssertionError(f"{variant} {kern} differs from the first build")
                    times[(variant, kern)].append(smoke._kernel_ms(fn, match, reps=3))
    for variant in VARIANTS:
        print(f"{variant}: " + "; ".join(
            f"{kern} " + ", ".join(f"{t:.3f}" for t in times[(variant, kern)]) + " ms"
            for kern in calls) + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
