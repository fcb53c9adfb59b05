"""Per-pixel attention heatmaps (counterpart of ``examples/attention_maps.py``;
reference notebooks/attention_maps.ipynb).

Uses NAF's introspectable ``return_weights=True`` path (scaled pre-softmax
scores, one k x k window of LR cells per query) and writes a heatmap panel
for chosen query pixels.

    python -m naf_torch.examples.attention_maps --pixels 100,100 300,220
    python -m naf_torch.examples.attention_maps --device cpu --size 64 --lr-size 8

Runs on the card unless given ``--device cpu``; raises without CUDA.
"""

import argparse
from typing import List, Sequence, Tuple

import numpy as np
import torch

from naf_torch.api import load_naf_params
from naf_torch.ops.window import cross_scale_lr_indices


def synthetic_image(size: int) -> np.ndarray:
    """A smooth (size, size, 3) test pattern in [0, 1]."""
    y, x = np.mgrid[0:size, 0:size]
    return np.stack(
        [np.sin(x / 19.0), np.cos(y / 13.0), np.sin((x - y) / 29.0)], -1
    ).astype(np.float32) * 0.5 + 0.5


def attention_maps(model, image: torch.Tensor, feats: torch.Tensor, size: int,
                   pixels: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    """For each query pixel (i, j) of the (size, size) output, its attention
    weights (softmax of the scores, averaged over the heads) laid on the
    (h, w) LR grid at the cells its window reads, scaled to a maximum of 1."""
    with torch.inference_mode():
        _, scores = model(image, feats, (size, size), return_weights=True)
    # scores: (B, heads, H, W, k*k), scaled pre-softmax (reference contract)
    weights = torch.softmax(scores.float(), dim=-1).mean(dim=1)[0].cpu().numpy()
    kk = int(round(np.sqrt(weights.shape[-1])))
    lr_h, lr_w = feats.shape[1], feats.shape[2]
    idx_h = cross_scale_lr_indices(size, lr_h, kk)
    idx_w = cross_scale_lr_indices(size, lr_w, kk)
    heats = []
    for i, j in pixels:
        heat = np.zeros((lr_h, lr_w), np.float32)
        heat[np.ix_(idx_h[i], idx_w[j])] = weights[i, j].reshape(kk, kk)
        heats.append(heat / max(heat.max(), 1e-9))
    return heats


def overlay_panel(img: np.ndarray, heats: Sequence[np.ndarray],
                  pixels: Sequence[Tuple[int, int]]) -> np.ndarray:
    """[image | image under each heatmap, its query pixel marked] as uint8."""
    from PIL import Image

    size = img.shape[0]
    panels = [img]
    for heat, (i, j) in zip(heats, pixels):
        hm = np.asarray(
            Image.fromarray((heat * 255).astype(np.uint8)).resize((size, size), Image.NEAREST),
            np.float32,
        )[..., None] / 255.0
        overlay = img * 0.4 + np.concatenate([hm, np.zeros_like(hm), 1 - hm], -1) * 0.6
        overlay[max(i - 2, 0):i + 2, max(j - 2, 0):j + 2] = [1, 1, 0]
        panels.append(overlay)
    return (np.concatenate(panels, axis=1) * 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m naf_torch.examples.attention_maps")
    ap.add_argument("--image", default=None)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--lr-size", type=int, default=28)
    ap.add_argument("--dim-feats", type=int, default=64)
    ap.add_argument("--pixels", nargs="+", default=["112,112"])
    ap.add_argument("--naf-ckpt", default=None)
    ap.add_argument("--out", default="attention_maps.png")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    from PIL import Image

    rng = np.random.RandomState(0)
    if args.image:
        from naf_torch.data.transforms import image_transform

        img = image_transform(Image.open(args.image), args.size)
    else:
        img = synthetic_image(args.size)
    model = load_naf_params(args.naf_ckpt, device=args.device)
    dev = next(model.parameters()).device
    image = torch.from_numpy(img)[None].to(dev)
    feats = torch.from_numpy(
        rng.randn(1, args.lr_size, args.lr_size, args.dim_feats).astype(np.float32)).to(dev)
    pixels = [tuple(int(v) for v in spec.split(",")) for spec in args.pixels]
    heats = attention_maps(model, image, feats, args.size, pixels)
    Image.fromarray(overlay_panel(img, heats, pixels)).save(args.out)
    print(f"attention maps for {args.pixels} -> {args.out}")


if __name__ == "__main__":
    main()
