"""Self-distillation quality loop on the committed real shard (counterpart of
``tools/train_distilled_eval.py``): train NAF, then probe the trained model.

    python -m naf_torch.evals.distill [STEPS] [--no-davis] [--tf32] [key=value ...]
    python -m naf_torch.evals.distill 4 --no-davis device=cpu num_epochs=1 img_size=144 \\
        target_size=48 backbone.depth=1 backbone.embed_dim=64 backbone.num_heads=2 \\
        out=build/d.json

Step by step as the JAX tool:

1. the frozen backbone is the seeded random ``vit_small_patch16_224`` of the
   real-shard probe (``real_shard.seg_args("naf")``), the model ``NAF()`` at
   full width (``config/model/naf.yaml``);
2. the probe dataset's training photographs (``<dataset.root>/images/
   training``, the shard's 60) are transformed at ``img_size`` (256) and kept
   on the device (``device_cached_stack``); ``train_upsampler`` runs STEPS
   (default 3000, the JAX record's) bf16 steps at batch 4 with
   ``down_factor="random"``, 100 steps a chunk (``make_train_chunk``), the
   lr size drawn per chunk as the JAX package draws it;
3. the probe at ``real_shard.seg_args("naf")`` with the trained weights
   injected (``seg_probing.main(argv, model_state)``), then DAVIS at
   ``real_shard.video_args()`` unless ``--no-davis``;
4. the same probe on the JAX package's trained weights
   (``naf_torch.convert.JAX_DISTILLED_NPZ``), recorded as
   ``seg_probing_naf_jax_ckpt3000``.

Words with ``=`` are appended to every probe's and DAVIS run's argument
list and configure the training from the same config (``img_size``,
``device``, ``backbone.*``, ``model.*``, ``dataset.root``); ``out=`` names
the JSON (default ``build/real_eval_distilled.json``), and the training's
run directory (``distill_naf/version_N``: ``metrics.jsonl``, checkpoints,
panels) and DAVIS's masks (``real_shard_runs_distilled``) go beside it.
Nothing is written under ``benchmarks/`` or ``runs/``. The JSON holds
``train_steps``, the training's wall time and steady step time (the mean
over the chunks after the first), each chunk's record, each probe's metrics
and seconds per epoch, every part's kernel launches
(``naf_torch.kernels.launch_counts``; the CPU's plain versions count none),
and ``tf32``: cuDNN's and cuBLAS's TF32 switches are off for the whole run
(the probe's and DAVIS's f32 convs and matmuls are f32) unless ``--tf32``
turns them on, and the caller's are restored after it.
``device`` defaults to ``cuda`` and raises without it. The backbone's
weights are not the JAX package's, so its numbers sit beside
``benchmarks/real_eval.json``'s and are no parity check.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import torch

from naf_torch.evals.real_shard import BUILD, REPO, seg_args, video_args

JAX_RECORD = REPO / "benchmarks" / "real_eval.json"


def train_distilled(cfg: dict, steps: int, log_dir: Path) -> tuple:
    """Steps 1-2: (the trained model's f32 state dict on the CPU, the
    training's record)."""
    from naf_torch.backbones import load_multiple_backbones
    from naf_torch.data.device_cache import device_cached_stack
    from naf_torch.data import image_folder
    from naf_torch.kernels import launch_counts, launches_since
    from naf_torch.train.trainer import TrainConfig, build_model, train_upsampler

    device = cfg.get("device", "cuda")
    img_size = cfg["img_size"]
    backbone = load_multiple_backbones(cfg["backbone"], dtype=torch.bfloat16, device=device)[0]
    model = build_model(cfg["model"])
    root = os.path.join(cfg["dataset"]["root"], "images", "training")
    stack = device_cached_stack(image_folder(root, img_size), device)
    print(f"device stack: {tuple(stack.shape)}", flush=True)
    tcfg = TrainConfig(train_steps=steps, img_size=img_size, batch_size=4, down_factor="random",
                       log_dir=str(log_dir), log_every=100)
    before = launch_counts()
    chunks = []
    t0 = time.perf_counter()
    model = train_upsampler(model, backbone, None, tcfg, device=device, device_stack=stack,
                            records=chunks)
    train_s = time.perf_counter() - t0
    sizes = [c["step"] - p["step"] for p, c in zip([{"step": -1}] + chunks, chunks)]
    steady = slice(1, None) if len(chunks) > 1 else slice(None)
    step_ms = 1e3 * sum(c["chunk_s"] for c in chunks[steady]) / sum(sizes[steady])
    rec = {"train_steps": steps, "train_s": train_s, "step_ms": step_ms, "photos": len(stack),
           "img_size": img_size, "batch_size": tcfg.batch_size, "log_dir": str(log_dir),
           "chunks": chunks, "launches": launches_since(before)}
    state = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    return state, rec


def _run(label, fn, argv, state, steps=None):
    """One probe or DAVIS run with the weights ``state`` injected; its
    metrics, seconds and kernel launches."""
    from naf_torch.kernels import launch_counts, launches_since

    print(f"== {label} ==", flush=True)
    before = launch_counts()
    t0 = time.perf_counter()
    out = fn(argv, model_state=state)
    return dict(out, seconds=time.perf_counter() - t0, launches=launches_since(before),
                **({} if steps is None else {"train_steps": steps}))


def main(argv):
    """The CLI; ``--tf32`` turns cuDNN's and cuBLAS's TF32 on for the whole
    run (off by default, so the f32 parts are f32), the caller's switches
    restored after it."""
    from naf_torch.utils.benchmarking import tf32

    with tf32("--tf32" in argv):
        return _main(argv)


def _main(argv):
    from naf_torch.config import load_config
    from naf_torch.convert import naf_state_from_npz
    from naf_torch.evals import seg_probing, video_seg
    from naf_torch.utils.benchmarking import card_line

    words = [a for a in argv if "=" not in a and not a.startswith("--")]
    steps = int(words[0]) if words else 3000
    extra = [a for a in argv if "=" in a and not a.startswith("out=")]
    out = Path(next((a[len("out="):] for a in argv if a.startswith("out=")),
                    BUILD / "real_eval_distilled.json")).resolve()
    probe_argv = [*seg_args("naf"), *extra]
    cfg = load_config("eval_probing", probe_argv)
    card = card_line() if torch.device(cfg.get("device", "cuda")).type == "cuda" else None

    state, train = train_distilled(cfg, steps, out.parent / "distill_naf")
    print(f"trained {steps} steps in {train['train_s']:.1f} s, {train['step_ms']:.3f} ms a step "
          f"after the first chunk; launches {train['launches']} "
          f"({ {k: v / steps for k, v in train['launches'].items()} } a step) ({card})",
          flush=True)
    results = {"_provenance": "naf_torch: NAF self-distilled on the real shard's training "
                              "photographs against a seeded random ViT-S/16 (not the JAX "
                              "package's backbone weights)",
               "card": card, "tf32": "--tf32" in argv, "train": train}
    runs = [("seg_probing_naf_distilled", seg_probing.main, probe_argv, state, steps)]
    if "--no-davis" not in argv:
        runs.append(("davis_jf_naf_distilled", video_seg.main,
                     [*video_args(), f"run_dir={out.parent / 'real_shard_runs_distilled'}",
                      *extra], state, steps))
    runs.append(("seg_probing_naf_jax_ckpt3000", seg_probing.main, probe_argv,
                 naf_state_from_npz(), None))
    with open(JAX_RECORD) as f:
        jax_record = json.load(f)
    for label, *args in runs:
        results[label] = rec = _run(label, *args)
        metric = "J&F-Mean" if label.startswith("davis") else "iou"
        jax_label = label.replace("_jax_ckpt3000", "_distilled")
        beside = jax_record.get(jax_label, {}).get(metric)
        epochs = rec.get("epoch_s", [])
        print(f"{label}: {metric} {rec[metric]:.4f} (JAX package's {jax_label}: "
              f"{beside if beside is None else round(beside, 4)}); {rec['seconds']:.1f} s"
              + (f", {sum(epochs) / len(epochs):.3f} s an epoch" if epochs else "")
              + f"; launches {rec['launches']} ({card})", flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
