"""The port's examples (``python -m naf_torch.examples.inference`` and
``.attention_maps``) on the CPU at tiny sizes, and the attention maps
against naf_tpu's ``return_weights`` path with the same
``cross_scale_lr_indices`` placement (examples/attention_maps.py), at
weights carried across (atol = rtol = 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from naf_torch.convert import state_dict_from_jax_params
from naf_torch.examples import attention_maps as tam
from naf_torch.examples import inference as tinf
from naf_torch.models.naf import NAF
from naf_tpu.models.naf import NAF as JNAF
from naf_tpu.ops.window import cross_scale_lr_indices

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _jax_maps(jm, params, img, feats, size, pixels):
    """examples/attention_maps.py's computation of the heatmaps."""
    _, scores = jm.apply({"params": params}, jnp.asarray(img)[None], jnp.asarray(feats),
                         (size, size), return_weights=True)
    weights = np.asarray(jax.nn.softmax(scores, axis=-1).mean(axis=1)[0])
    kk = int(np.sqrt(weights.shape[-1]))
    idx = cross_scale_lr_indices(size, feats.shape[1], kk)
    heats = []
    for i, j in pixels:
        heat = np.zeros(feats.shape[1:3], np.float32)
        heat[np.ix_(idx[i], idx[j])] = weights[i, j].reshape(kk, kk)
        heats.append(heat / max(heat.max(), 1e-9))
    return heats


@pytest.mark.parametrize("size,lr,pixels", [
    (32, 4, [(5, 5), (20, 10), (31, 0)]),
    (40, 6, [(0, 39), (17, 23)]),        # a ragged ratio (40 / 6)
], ids=["r8", "ragged"])
def test_attention_maps_match_jax(size, lr, pixels):
    img = tam.synthetic_image(size)
    feats = np.random.RandomState(0).randn(1, lr, lr, 16).astype(np.float32)
    jm = JNAF(na_impl="xla")
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(img)[None], jnp.asarray(feats),
                     (size, size))["params"]
    model = NAF()
    model.load_state_dict(state_dict_from_jax_params(params))
    got = tam.attention_maps(model.eval(), torch.from_numpy(img)[None],
                             torch.from_numpy(feats), size, pixels)
    want = _jax_maps(jm, params, img, feats, size, pixels)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
        assert g.max() == pytest.approx(1.0)
    panel = tam.overlay_panel(img, got, pixels)
    assert panel.shape == (size, size * (1 + len(pixels)), 3) and panel.dtype == np.uint8


def test_attention_maps_cli_on_cpu(tmp_path):
    out = tmp_path / "maps.png"
    tam.main(["--device", "cpu", "--size", "32", "--lr-size", "4", "--dim-feats", "8",
              "--pixels", "5,5", "20,10", "--out", str(out)])
    assert Image.open(out).size == (3 * 32, 32)


@pytest.mark.parametrize("dtype_args", [["--f32"], []], ids=["f32", "bf16"])
def test_inference_cli_on_cpu(tmp_path, dtype_args):
    out = tmp_path / "panel.png"
    tinf.main(["--device", "cpu", "--img-size", "28", "--target-sizes", "28", "56",
               "--out", str(out), *dtype_args])
    # image | LR features | two NAF outputs, each panel 56 high
    assert Image.open(out).size[1] == 56 and Image.open(out).size[0] >= 4 * 56


def test_upsample_panels_shapes():
    from naf_torch.api import load_naf_params
    from naf_torch.backbones import PretrainedViTWrapper

    bb = PretrainedViTWrapper("vit_small_patch14_dinov2.lvd142m", device="cpu", depth=1)
    model = load_naf_params(device="cpu")
    image = torch.from_numpy(tinf.synthetic_image(28))[None]
    lr, hr = tinf.upsample_panels(image, bb, model, [42])
    assert lr.shape == (1, 2, 2, 384) and hr.shape == (1, 42, 42, 384)
    assert lr.dtype == hr.dtype == np.float32 and np.isfinite(hr).all()


def test_examples_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (tinf.main, tam.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--out", str(tmp_path / "x.png")])
