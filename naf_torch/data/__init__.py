"""Datasets, transforms and the threaded loader (counterpart of ``naf_tpu/data``)."""

from naf_torch.data.datasets import (  # noqa: F401
    ADE20KDataset,
    CityscapesDataset,
    COCOStuffDataset,
    DAVISFramesDataset,
    ImageFolderDataset,
    KITTI360Dataset,
    VOCDataset,
    image_folder,
)
from naf_torch.data.loader import DataLoader  # noqa: F401
from naf_torch.data.transforms import image_transform, label_transform  # noqa: F401
