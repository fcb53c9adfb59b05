"""The JAX package's trained NAF (naf_torch/assets/naf_distill_jax_ckpt3000.npz)
on the card: it loads strictly, and the bf16 forward on the kernels (8 K1 +
1 K2) at 448^2 + 28^2 x 384 -> 448^2, on a real-shard photograph with
seeded features, agrees with the f32 plain path (the same weights on the
CPU, where every wrapper runs its plain version) at cosine > 0.999.

Every test carries the marker ``cuda`` and skips without a card. The file
imports no JAX:

    python -m pytest -m cuda tests/test_torch_card_distill.py -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from naf_torch.convert import naf_state_from_npz
from naf_torch.data.transforms import image_transform
from naf_torch.kernels import launch_counts, launches_since
from naf_torch.models.naf import NAF

PHOTO = (Path(__file__).resolve().parents[1] / "benchmarks" / "real_shard" / "ade20k" / "images"
         / "training")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 21 runs the quality loop there")
    return torch.device("cuda")


def _inputs():
    photo = image_transform(Image.open(sorted(PHOTO.iterdir())[0]).convert("RGB"), 448)
    image = (photo - np.array(IMAGENET_DEFAULT_MEAN)) / np.array(IMAGENET_DEFAULT_STD)
    feats = np.random.RandomState(0).randn(1, 28, 28, 384)
    return (torch.from_numpy(image[None].astype(np.float32)),
            torch.from_numpy(feats.astype(np.float32)))


@pytest.mark.cuda
def test_jax_trained_naf_on_the_card(cuda_device):
    state = naf_state_from_npz()
    card = NAF().to(cuda_device, torch.bfloat16).eval()
    card.load_state_dict(state)
    plain = NAF().eval()
    plain.load_state_dict(state)
    image, feats = _inputs()
    before = launch_counts()
    with torch.no_grad():
        got = card(image.to(cuda_device, torch.bfloat16), feats.to(cuda_device, torch.bfloat16),
                   (448, 448))
        torch.cuda.synchronize()
        launches = launches_since(before)
        want = plain(image, feats, (448, 448))
    assert (launches["k1"], launches["k2"]) == (8, 1)
    assert got.shape == want.shape == (1, 448, 448, 384) and torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got.float().cpu().reshape(1, -1),
                                                want.reshape(1, -1)).item()
    assert cos > 0.999, cos
