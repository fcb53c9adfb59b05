"""The training CLI's real-data path (counterpart of ``naf_tpu/data``)."""

from naf_torch.data.datasets import ImageFolderDataset  # noqa: F401
from naf_torch.data.loader import DataLoader  # noqa: F401
from naf_torch.data.transforms import image_transform, label_transform  # noqa: F401
