"""The JAX package's denoiser step, sized by XLA without running it.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_denoise_memory.py [--batch 8] [--size 448]

Lowers and compiles ``naf_tpu.train.denoise``'s jitted step (``_make_step``:
noise, ImageNet normalisation, the bf16 forward and ``jax.value_and_grad``
on f32 master parameters, optax AdamW) for ``benchmarks/denoising.json``'s
NAF (dim 256, one attention and one RoPE head, k 15, 2 encoder layers; sigma
0.5) at the given batch and size, from abstract shapes only, and prints
``compiled.memory_analysis()``: the argument, output, alias and temporary
bytes of XLA's buffer assignment. On the CPU the step takes the JAX
package's XLA paths (no Pallas kernel), and XLA's CPU buffer assignment is
not the TPU's: the figure sizes the step's live buffers on this backend,
not the TPU run's peak.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import optax

from naf_tpu.evals.denoising import DenoisingLoss, NoiseGenerator
from naf_tpu.models.naf import NAF
from naf_tpu.train.denoise import _make_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=448)
    args = ap.parse_args()
    hw = (args.size, args.size)
    model = NAF(dim=256, heads_attn=1, heads_rope=1, kernel_size=15, img_layers=2,
                rope_rescale=2.0)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), dummy, dummy,
                                               (32, 32))["params"])
    tx = optax.adamw(2e-4, weight_decay=1e-5)
    opt_state = jax.eval_shape(tx.init, params)
    step = _make_step(model, tx, DenoisingLoss(1.0, 5.0, 0.2), NoiseGenerator("gaussian"),
                      {"std": 0.5}, hw, use_bf16=True)
    clean = jax.ShapeDtypeStruct((args.batch, *hw, 3), jnp.float32)
    t0 = time.time()
    compiled = step.lower(params, opt_state, clean, jax.random.PRNGKey(0)).compile()
    mem = compiled.memory_analysis()
    rec = {k: getattr(mem, f"{k}_size_in_bytes") for k in
           ("argument", "output", "alias", "temp", "generated_code")}
    rec.update(batch=args.batch, size=args.size, backend=jax.default_backend(),
               compile_s=round(time.time() - t0, 1),
               mib={k: round(v / 2**20, 1) for k, v in rec.items() if isinstance(v, int)})
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
