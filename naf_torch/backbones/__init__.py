from naf_torch.backbones.vit import ViT, ViTConfig  # noqa: F401
from naf_torch.backbones.wrapper import (  # noqa: F401
    BACKBONE_REGISTRY,
    PretrainedViTWrapper,
    backbone_config,
    load_multiple_backbones,
)
