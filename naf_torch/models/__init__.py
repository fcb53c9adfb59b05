from naf_torch.models.naf import NAF, ImageEncoder  # noqa: F401
