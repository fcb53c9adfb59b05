"""The evaluation harnesses on the committed real shard (counterpart of
``evaluation/eval_real_shard.py``, with its argument lists).

``benchmarks/real_shard/`` holds real photographs with procedural
annotations in the ADE20K and DAVIS layouts. This runs the port's
linear-probe segmentation for ``naf`` and ``bilinear`` (backbone
``vit_small_patch16_224``, img 256, 8 epochs, batches 2 / 1, 7 classes) and
DAVIS label propagation with ``naf`` at ``eval.ups_factor=2``, on seeded
random weights, and writes the metrics as JSON:

    python -m naf_torch.evals.real_shard              # both
    python -m naf_torch.evals.real_shard seg          # probing only
    python -m naf_torch.evals.real_shard video        # DAVIS J&F only
    python -m naf_torch.evals.real_shard seg device=cpu num_epochs=1 out=build/x.json

Words with ``=`` are appended to every run's argument list (``out=`` sets
the JSON file, default ``build/real_eval.json``; the DAVIS results go to
``build/real_shard_runs`` unless ``run_dir=`` says otherwise). Nothing is
written under ``benchmarks/``. The weights are not the JAX package's, so
the numbers are not those of ``benchmarks/real_eval.json``.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SHARD = REPO / "benchmarks" / "real_shard"
BUILD = REPO / "build"


def seg_args(model: str):
    """``evaluation/eval_real_shard.py``'s seg-probing argument list."""
    return [f"model={model}", "dataset=ade20k", f"dataset.root={SHARD / 'ade20k'}",
            "dataset.num_classes=7", "img_size=256", "num_epochs=8",
            "train_dataloader.batch_size=2", "val_dataloader.batch_size=1",
            "backbone.name=vit_small_patch16_224"]


def video_args():
    """``evaluation/eval_real_shard.py``'s DAVIS argument list (the results
    under ``build/real_shard_runs``)."""
    return ["model=naf", f"dataroot={SHARD}", f"dataset.root={SHARD / 'davis'}",
            "eval.ups_factor=2", "backbone.name=vit_small_patch16_224",
            f"run_dir={BUILD / 'real_shard_runs'}"]


def run_seg(results, extra):
    from naf_torch.evals import seg_probing

    for model in ("naf", "bilinear"):
        print(f"== seg probing: {model} ==", flush=True)
        results[f"seg_probing_{model}"] = seg_probing.main([*seg_args(model), *extra])


def run_video(results, extra):
    from naf_torch.evals import video_seg

    print("== DAVIS propagation: naf ==", flush=True)
    results["davis_jf_naf"] = video_seg.main([*video_args(), *extra])


def main(argv):
    which = {a for a in argv if "=" not in a} or {"seg", "video"}
    extra = [a for a in argv if "=" in a and not a.startswith("out=")]
    out = next((a[len("out="):] for a in argv if a.startswith("out=")),
               str(BUILD / "real_eval.json"))
    results = {"_provenance": "naf_torch on seeded random weights; real photographs with "
                              "procedural annotations (benchmarks/real_shard)"}
    if "seg" in which:
        run_seg(results, extra)
    if "video" in which:
        run_video(results, extra)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
