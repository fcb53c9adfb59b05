"""The denoising ablation on the committed real shard (counterpart of
``tools/run_denoising_bench.py``): NAF, REDNet and IRCNN trained and
validated by ``naf_torch.denoising.main`` with the JAX tool's command lines.

    python -m naf_torch.evals.denoise_bench [naf|rednet|ircnn ...] [--tf32] [key=value ...]
    python -m naf_torch.evals.denoise_bench ircnn train_steps=2 val_steps=1 img_size=32 \\
        train_dataloader.batch_size=2 device=cpu out=build/d.json

Each model runs ``MODELS[name] + COMMON`` (the JAX tool's lists: sigma 0.5,
4000 steps at batch 8, 448^2, 54 validation batches) plus
``run_dir=<dir of out>/denoise_<name>``, then the words with ``=`` given here
(``train_steps=N`` and the like; later words win). Run it from the
repository root: the dataset paths are relative, as in the JAX tool. Each
model's entry in the JSON (``out=``, default ``build/denoising.json``;
nothing is written under ``benchmarks/`` or ``runs/``) holds ``psnr``,
``ssim``, ``train_s`` (the call's wall time, validation included),
``overrides``, the training and validation folders with their photograph
counts (the shard holds 60 training photographs; the JAX record's run had
18), and the kernel launches of the call (``naf_torch.kernels.
launch_counts``: NAF's K1, K2, K3 and K4; the restorers launch none). The
JSON's ``tf32`` says whether cuDNN's and cuBLAS's TF32 switches were on:
off for the whole run (validation's f32 convs and matmuls are f32) unless
``--tf32`` turns them on; the caller's are restored after it.
``device`` defaults to ``cuda`` and raises without it.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from naf_torch.evals.real_shard import BUILD, REPO

MODELS = {
    "naf": [
        "model=naf", "model.kernel_size=15", "model.heads_attn=1",
        "model.heads_rope=1",
    ],
    "rednet": ["model=rednet"],
    "ircnn": ["model=ircnn"],
}

COMMON = [
    "denoising.noise_params.std=0.5",
    "train_steps=4000",
    "val_steps=54",  # 54 x bs2 = 108 noisy views of the 9 held-out images
    "train_dataloader.batch_size=8",
    "dataset.root=benchmarks/real_shard/ade20k/images/training",
    "dataset.val_root=benchmarks/real_shard/ade20k/images/validation",
]

JAX_RECORD = REPO / "benchmarks" / "denoising.json"


def _photos(overrides, key) -> dict:
    """The folder the last ``key=`` override names, and its photographs."""
    from naf_torch.data import image_folder

    root = [a.split("=", 1)[1] for a in overrides if a.startswith(f"{key}=")][-1]
    return {"root": root, "photos": len(image_folder(root, img_size=0))}


def run_model(name: str, run_root: Path, extra=()) -> dict:
    """One model's training and validation; its JSON entry."""
    from naf_torch.denoising import main as denoise_main
    from naf_torch.kernels import launch_counts, launches_since

    overrides = [*MODELS[name], *COMMON, f"run_dir={run_root / f'denoise_{name}'}", *extra]
    before = launch_counts()
    t0 = time.perf_counter()
    metrics = denoise_main(overrides)
    return {**metrics, "train_s": time.perf_counter() - t0, "overrides": overrides,
            "train": _photos(overrides, "dataset.root"),
            "val": _photos(overrides, "dataset.val_root"),
            "launches": launches_since(before)}


def main(argv):
    """The CLI; ``--tf32`` turns cuDNN's and cuBLAS's TF32 on for the whole
    run (off by default, so the f32 parts are f32), the caller's switches
    restored after it."""
    from naf_torch.utils.benchmarking import tf32

    with tf32("--tf32" in argv):
        return _main(argv)


def _main(argv):
    from naf_torch.utils.benchmarking import card_line

    which = [a for a in argv if "=" not in a and not a.startswith("--")] or list(MODELS)
    extra = [a for a in argv if "=" in a and not a.startswith("out=")]
    out = Path(next((a[len("out="):] for a in argv if a.startswith("out=")),
                    BUILD / "denoising.json")).resolve()
    with open(JAX_RECORD) as f:
        jax_models = json.load(f)["models"]
    results = {"_protocol": "tools/run_denoising_bench.py's: gaussian sigma=0.5, "
                            "4000 steps @448^2, PSNR on held-out real photos with fresh noise",
               "_data": "benchmarks/real_shard (the training and validation photographs each "
                        "entry counts)",
               "card": (card_line() if "device=cpu" not in extra and torch.cuda.is_available()
                        else None),
               "tf32": "--tf32" in argv, "models": {}}
    out.parent.mkdir(parents=True, exist_ok=True)
    for name in which:
        print(f"=== training {name} ===", flush=True)
        results["models"][name] = rec = run_model(name, out.parent, extra)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"{name}: PSNR {rec['psnr']:.4f} dB, SSIM {rec['ssim']:.4f} (JAX package's "
              f"{jax_models[name]['psnr']:.2f} dB on 18 training photographs); "
              f"{rec['train_s']:.1f} s on {rec['train']['photos']} training photographs; "
              f"launches {rec['launches']} ({results['card']})", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
