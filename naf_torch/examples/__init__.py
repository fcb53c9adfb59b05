"""The repository's examples on the port (counterparts of ``examples/``):

    python -m naf_torch.examples.inference        # PCA panel: image | LR | NAF-upsampled
    python -m naf_torch.examples.attention_maps   # per-pixel attention heatmaps

Both run on the card unless given ``--device cpu``."""
