from naf_torch.config.core import get_feature, get_patch_size, load_config  # noqa: F401
