"""Dataset readers (the port's own copy of ``naf_tpu/data/datasets.py``,
reference evaluation/dataset/*), PIL + numpy.

``ImageFolderDataset`` items are {"image": transformed image, "label": class
index}. The segmentation datasets yield {"image": (H, W, 3) f32 [0, 1]
after ``transform``, "label": (H', W') int32 after ``target_transform``};
the ignore label is 255 (Cityscapes' and KITTI-360's unlabelled ids and
COCO-Stuff's unmapped ones become 255).
"""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from naf_torch.data.coco_mapping import FINE_TO_COARSE
from naf_torch.data.transforms import image_transform

__all__ = [
    "ImageFolderDataset",
    "image_folder",
    "ADE20KDataset",
    "CityscapesDataset",
    "COCOStuffDataset",
    "VOCDataset",
    "KITTI360Dataset",
    "DAVISFramesDataset",
]

# the image-folder listings of ``image_folder``, under the checkout's build/
LISTINGS = Path(__file__).resolve().parents[2] / "build" / "listings"

IGNORE = 255


class _SegDataset:
    """(image, label) pairs of paths, read with PIL and transformed."""

    def __init__(self, pairs, transform, target_transform):
        self.pairs = pairs
        self.transform = transform
        self.target_transform = target_transform

    def __len__(self):
        return len(self.pairs)

    def _load(self, index):
        from PIL import Image

        img_path, lbl_path = self.pairs[index]
        image = Image.open(img_path).convert("RGB")
        label = Image.open(lbl_path)
        image = self.transform(image) if self.transform else np.asarray(image)
        label = (self.target_transform(label) if self.target_transform
                 else np.asarray(label).astype(np.int32))
        return image, label

    def __getitem__(self, index):
        image, label = self._load(index)
        return {"image": image, "label": label}


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



def image_folder(root: str, img_size: int) -> ImageFolderDataset:
    """The photographs under ``root`` at ``img_size`` (``image_transform``),
    the listing cached under ``LISTINGS`` (never beside ``root``, which may
    be a committed folder)."""
    LISTINGS.mkdir(parents=True, exist_ok=True)
    cache = LISTINGS / os.path.abspath(root).strip(os.sep).replace(os.sep, "_")
    return ImageFolderDataset(root, transform=lambda im: image_transform(im, img_size),
                              root_cache=str(cache))

class ADE20KDataset(_SegDataset):
    """ADE20K SceneParsing, 151 classes with the background
    (evaluation/dataset/ade20k.py:9-231)."""

    SPLIT_DIR = {"train": "training", "val": "validation"}
    NUM_CLASSES = 151

    def __init__(self, root, transform=None, target_transform=None, split="train",
                 check_sizes=False, num_classes=None, tag=None):
        image_dir = os.path.join(root, f"images/{self.SPLIT_DIR[split]}")
        ann_dir = os.path.join(root, f"annotations/{self.SPLIT_DIR[split]}")
        pairs = [(os.path.join(image_dir, i), os.path.join(ann_dir, a))
                 for i, a in zip(sorted(os.listdir(image_dir)), sorted(os.listdir(ann_dir)))]
        if check_sizes:
            _check_count("ADE20K", split, pairs, {"train": 20210, "val": 2000})
        super().__init__(pairs, transform, target_transform)


# Cityscapes' 34 raw ids -> 19 train ids (-1: ignored), cityscapesScripts'
# mapping (evaluation/dataset/cityscapes.py:36-43)
_CITYSCAPES_KEY = np.array(
    [-1, -1, -1, -1, -1, -1, -1, 0, 1, -1, -1, 2, 3, 4, -1, -1, -1, 5, -1,
     6, 7, 8, 9, 10, 11, 12, 13, 14, 15, -1, -1, 16, 17, 18], np.int32)


def _train_ids(label: np.ndarray) -> np.ndarray:
    """Cityscapes raw ids -> train ids, the ignored ones 255."""
    label = _CITYSCAPES_KEY[np.clip(label, 0, len(_CITYSCAPES_KEY) - 1)]
    return np.where(label < 0, IGNORE, label).astype(np.int32)


def _check_count(name, split, pairs, expect):
    if len(pairs) != expect[split]:
        raise ValueError(f"{name} {split} has {len(pairs)} pairs, expected {expect[split]}")


class CityscapesDataset(_SegDataset):
    """Cityscapes fine semantic segmentation, 19 train classes
    (evaluation/dataset/cityscapes.py)."""

    NUM_CLASSES = 19

    def __init__(self, root, transform=None, target_transform=None, split="train",
                 check_sizes=False, num_classes=None, tag=None):
        img_root = os.path.join(root, "leftImg8bit", split)
        lbl_root = os.path.join(root, "gtFine", split)
        pairs = []
        for city in sorted(os.listdir(img_root)):
            for fn in sorted(os.listdir(os.path.join(img_root, city))):
                lbl = fn.replace("_leftImg8bit.png", "_gtFine_labelIds.png")
                pairs.append((os.path.join(img_root, city, fn),
                              os.path.join(lbl_root, city, lbl)))
        if check_sizes:
            _check_count("Cityscapes", split, pairs, {"train": 2975, "val": 500})
        super().__init__(pairs, transform, target_transform)

    def __getitem__(self, index):
        image, label = self._load(index)
        return {"image": image, "label": _train_ids(label)}


class COCOStuffDataset(_SegDataset):
    """COCO-Stuff with 27 coarse classes (evaluation/dataset/coco.py)."""

    NUM_CLASSES = 27

    def __init__(self, root, transform=None, target_transform=None, split="train",
                 coarse_labels=True, check_sizes=False, num_classes=None, tag=None):
        img_dir = os.path.join(root, "images", f"{split}2017")
        lbl_dir = os.path.join(root, "annotations", f"{split}2017")
        pairs = [(os.path.join(img_dir, f), os.path.join(lbl_dir, f.replace(".jpg", ".png")))
                 for f in sorted(os.listdir(img_dir))]
        if check_sizes:
            _check_count("COCO-Stuff", split, pairs, {"train": 97702, "val": 4172})
        super().__init__(pairs, transform, target_transform)
        self.coarse_labels = coarse_labels
        lut = np.full(256, -1, np.int32)
        for fine, coarse in FINE_TO_COARSE.items():
            lut[fine] = coarse
        self._lut = lut

    def __getitem__(self, index):
        image, label = self._load(index)
        coarse = np.where(label == 255, -1, self._lut[np.clip(label, 0, 255)])  # coco.py:297
        out = coarse if self.coarse_labels else label
        return {"image": image, "label": np.where(out < 0, IGNORE, out).astype(np.int32)}


class VOCDataset(_SegDataset):
    """PASCAL VOC2012 segmentation, 21 classes (evaluation/dataset/voc.py)."""

    NUM_CLASSES = 21

    def __init__(self, root, transform=None, target_transform=None, split="train",
                 check_sizes=False, num_classes=None, tag=None):
        base = os.path.join(root, "VOCdevkit", "VOC2012")
        if not os.path.isdir(base):
            base = root
        with open(os.path.join(base, "ImageSets", "Segmentation", f"{split}.txt")) as f:
            names = [line.strip() for line in f if line.strip()]
        pairs = [(os.path.join(base, "JPEGImages", f"{n}.jpg"),
                  os.path.join(base, "SegmentationClass", f"{n}.png")) for n in names]
        if check_sizes:
            _check_count("VOC", split, pairs, {"train": 1464, "val": 1449})
        super().__init__(pairs, transform, target_transform)


class KITTI360Dataset(_SegDataset):
    """KITTI-360 semantics (Cityscapes' id -> train id mapping) with a
    seeded 80/20 split kept in a json file
    (evaluation/dataset/kitti360.py:110-155)."""

    NUM_CLASSES = 19

    def __init__(self, root, transform=None, target_transform=None, split="train",
                 split_file=None, seed=0, num_classes=None, tag=None):
        lbl_glob = os.path.join(root, "data_2d_semantics", "train", "*", "image_00",
                                "semantic", "*.png")
        pairs = []
        for lbl in sorted(glob.glob(lbl_glob)):
            parts = lbl.split(os.sep)
            seq, fn = parts[-4], parts[-1]
            img = os.path.join(root, "data_2d_raw", seq, "image_00", "data_rect", fn)
            if os.path.exists(img):
                pairs.append((img, lbl))
        split_file = split_file or os.path.join(root, "naf_split.json")
        if os.path.exists(split_file):
            with open(split_file) as f:
                idx = json.load(f)[split]
        else:
            perm = np.random.RandomState(seed).permutation(len(pairs))
            cut = int(len(pairs) * 0.8)
            splits = {"train": perm[:cut].tolist(), "val": perm[cut:].tolist()}
            try:
                with open(split_file, "w") as f:
                    json.dump(splits, f)
            except OSError:
                pass
            idx = splits[split]
        super().__init__([pairs[i] for i in idx], transform, target_transform)

    def __getitem__(self, index):
        image, label = self._load(index)
        return {"image": image, "label": _train_ids(label)}


class DAVISFramesDataset(_SegDataset):
    """DAVIS 2017 frames with their annotations (evaluation/dataset/davis.py)."""

    def __init__(self, root, transform=None, target_transform=None, split="val",
                 num_classes=None, tag=None):
        with open(os.path.join(root, "ImageSets", "2017", f"{split}.txt")) as f:
            videos = [line.strip() for line in f if line.strip()]
        pairs = []
        for video in videos:
            for fr in sorted(glob.glob(os.path.join(root, "JPEGImages", "480p", video, "*.jpg"))):
                pairs.append((fr, fr.replace("JPEGImages", "Annotations").replace(".jpg", ".png")))
        super().__init__(pairs, transform, target_transform)
        self.videos = videos
