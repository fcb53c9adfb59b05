from naf_torch.backbones.vit import ViT, ViTConfig  # noqa: F401
from naf_torch.backbones.wrapper import (  # noqa: F401
    BACKBONE_REGISTRY,
    PretrainedViTWrapper,
    load_multiple_backbones,
)
