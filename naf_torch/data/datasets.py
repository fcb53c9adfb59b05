"""Image-folder dataset (the port's own copy of
``naf_tpu/data/datasets.py::ImageFolderDataset``, reference
evaluation/dataset/image_dataset.py:16-118), PIL + numpy.

Items are {"image": transformed image, "label": class index}. The
segmentation datasets come with the evaluation slice.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

__all__ = ["ImageFolderDataset"]


class ImageFolderDataset:
    """ImageNet-style class folders. The file listing is cached at
    ``<root>.txt`` (or ``<root_cache>.txt``) to skip the directory walk."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 root_cache: Optional[str] = None, num_classes=None, tag=None):
        self.root = root
        self.transform = transform
        cache = (root_cache or root).rstrip("/") + ".txt"
        if os.path.exists(cache):
            with open(cache) as f:
                rel = [line.strip() for line in f if line.strip()]
        else:
            rel = [os.path.relpath(os.path.join(dirpath, fn), root)
                   for dirpath, _, files in sorted(os.walk(root))
                   for fn in sorted(files) if fn.lower().endswith(self.EXTS)]
            try:
                with open(cache, "w") as f:
                    f.write("\n".join(rel))
            except OSError:
                pass
        self.samples = [os.path.join(root, r) for r in rel]
        classes = sorted({os.path.dirname(r) for r in rel})
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.targets = [self.class_to_idx[os.path.dirname(r)] for r in rel]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        from PIL import Image

        image = Image.open(self.samples[index]).convert("RGB")
        if self.transform:
            image = self.transform(image)
        return {"image": image, "label": self.targets[index]}
