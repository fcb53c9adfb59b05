"""Zero-shot upsampling demo (counterpart of ``examples/inference.py``;
reference notebooks/inference.ipynb).

Any backbone, any resolution, including the 64 -> 1024 sweep. Saves a PCA
feature panel (image | LR features | NAF-upsampled features).

    python -m naf_torch.examples.inference --image photo.jpg \\
        --backbone-ckpt dinov2_small.pth --naf-ckpt naf_release.pth
    python -m naf_torch.examples.inference      # synthetic image, random weights
    python -m naf_torch.examples.inference --device cpu --f32 --img-size 56 \\
        --target-sizes 56 112                   # the plain path on the CPU

Runs on the card unless given ``--device cpu``; raises without CUDA.
"""

import argparse
from typing import List, Sequence

import numpy as np
import torch

from naf_torch.api import load_naf_params
from naf_torch.backbones import PretrainedViTWrapper
from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from naf_torch.utils.spans import to_device
from naf_torch.utils.visualization import plot_feats


def synthetic_image(size: int) -> np.ndarray:
    """A smooth (size, size, 3) test pattern in [0, 1]."""
    y, x = np.mgrid[0:size, 0:size]
    return np.stack(
        [np.sin(x / 23.0), np.cos(y / 17.0), np.sin((x + y) / 31.0)], -1
    ).astype(np.float32) * 0.5 + 0.5


def upsample_panels(image01: torch.Tensor, backbone: PretrainedViTWrapper, model,
                    target_sizes: Sequence[int]) -> List[np.ndarray]:
    """The backbone's LR features of a (1, H, W, 3) [0, 1] image, then NAF's
    upsampling of them to each target size (guided by the ImageNet-normalised
    image), as f32 NHWC arrays."""
    mean = to_device(IMAGENET_DEFAULT_MEAN, image01.device, image01.dtype)
    std = to_device(IMAGENET_DEFAULT_STD, image01.device, image01.dtype)
    with torch.inference_mode():
        lr_feats = backbone(backbone.normalize(image01))
        panels = [lr_feats] + [model((image01 - mean) / std, lr_feats, (ts, ts))
                               for ts in target_sizes]
    return [p.float().cpu().numpy() for p in panels]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m naf_torch.examples.inference")
    ap.add_argument("--image", default=None)
    ap.add_argument("--backbone", default="vit_small_patch14_dinov2.lvd142m")
    ap.add_argument("--backbone-ckpt", default=None)
    ap.add_argument("--naf-ckpt", default=None)
    ap.add_argument("--img-size", type=int, default=448)
    ap.add_argument("--target-sizes", type=int, nargs="+", default=[448])
    ap.add_argument("--out", default="naf_panel.png")
    ap.add_argument("--f32", action="store_true", help="float32 (bf16 default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    if args.image:
        from PIL import Image

        from naf_torch.data.transforms import image_transform

        img = image_transform(Image.open(args.image), args.img_size)
    else:
        print("no --image given; using a synthetic test pattern")
        img = synthetic_image(args.img_size)

    dtype = torch.float32 if args.f32 else torch.bfloat16
    backbone = PretrainedViTWrapper(args.backbone, checkpoint=args.backbone_ckpt, dtype=dtype,
                                    device=args.device)
    model = load_naf_params(args.naf_ckpt, device=args.device, dtype=dtype)
    image = to_device(img[None], next(model.parameters()).device, dtype)
    panels = upsample_panels(image, backbone, model, args.target_sizes)
    print(f"LR features: {panels[0].shape}")
    for ts, hr in zip(args.target_sizes, panels[1:]):
        print(f"NAF {ts}x{ts}: {hr.shape}")
    plot_feats(img, panels, args.out)
    print(f"panel written to {args.out}")


if __name__ == "__main__":
    main()
