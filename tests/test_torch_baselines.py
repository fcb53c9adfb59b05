"""The upsampler baselines and their registry (naf_torch.models) against
naf_tpu, f32 on the CPU, atol = rtol = 2e-4 unless stated.

Inputs come from numpy seeds; JAX params are initialized, perturbed and
converted with ``naf_torch.convert``; kernel K5's plain version is held
against the JAX Pallas kernel in interpret mode, as the JAX package's own
tests run it. The CUDA kernel runs only on the card: its ``cuda``-marked test
skips here, and ``chip_smoke.py`` holds it at the main path's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.convert import (
    anyup_state_dict_from_jax,
    featup_state_dict_from_jax,
    jafar_state_dict_from_jax,
    jbu_state_dict_from_jax,
)
from naf_torch.kernels.adaptive_conv_fused import adaptive_conv_fused, adaptive_conv_fused_ref
from naf_torch.models.anyup import AnyUpsampler, anyup_state_dict_from_torch
from naf_torch.models.featup import JBU, FeatUp
from naf_torch.models.jafar import JAFAR
from naf_torch.models.jbf import JBF
from naf_torch.models.registry import ModelWrapper, build_model, register
from naf_torch.models.simple import Bilinear, Nearest
from naf_torch.ops.adaptive_conv import adaptive_conv, reflect_pad2d, unfold_nhwc
from naf_tpu.kernels.adaptive_conv_fused import adaptive_conv_fused as j_adaptive_conv_fused
from naf_tpu.models import anyup as j_anyup
from naf_tpu.models import featup as j_featup
from naf_tpu.models import jafar as j_jafar
from naf_tpu.models import jbf as j_jbf
from naf_tpu.models import simple as j_simple
from naf_tpu.ops import adaptive_conv as j_ac

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _rand(seed, *shape, s=1.0):
    return (np.random.RandomState(seed).randn(*shape) * s).astype(np.float32)


def _image(seed, hw):
    return np.random.RandomState(seed).rand(1, hw, hw, 3).astype(np.float32)


@pytest.mark.parametrize("shape,pad", [((2, 9, 11, 3), 3), ((1, 6, 7, 5), 5), ((1, 4, 4, 2), 0)])
def test_reflect_pad_and_unfold_match_jax_exactly(shape, pad):
    x = _rand(0, *shape)
    got = reflect_pad2d(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_ac.reflect_pad2d(jnp.asarray(x), pad)))
    k = 2 * pad + 1
    np.testing.assert_array_equal(
        unfold_nhwc(torch.from_numpy(got), k).numpy(),
        np.asarray(j_ac.unfold_nhwc(jnp.asarray(got), k)))


def test_reflect_pad_refuses_a_pad_torch_cannot_reflect():
    with pytest.raises(ValueError, match="reflect padding"):
        reflect_pad2d(torch.zeros(1, 3, 8, 2), 3)


@pytest.mark.parametrize("b,h,w,c,k", [(2, 16, 32, 128, 7), (1, 14, 17, 3, 11)])
def test_adaptive_conv_ref_matches_jax(b, h, w, c, k):
    """K5's plain version and the op against the Pallas kernel (interpret
    mode, where its shape rules allow) and JAX's adaptive_conv, at 1e-5."""
    src = _rand(1, b, h + k - 1, w + k - 1, c)
    ker = np.random.RandomState(2).rand(b, h, w, k, k).astype(np.float32)
    got = adaptive_conv_fused_ref(torch.from_numpy(src), torch.from_numpy(ker)).numpy()
    want = np.asarray(j_ac.adaptive_conv(jnp.asarray(src), jnp.asarray(ker)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if c % 128 == 0:
        pallas = j_adaptive_conv_fused(jnp.asarray(src), jnp.asarray(ker), interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=1e-5)
    # on CPU tensors the wrapper and the op are the plain version
    np.testing.assert_array_equal(
        adaptive_conv_fused(torch.from_numpy(src), torch.from_numpy(ker)).numpy(), got)
    np.testing.assert_array_equal(
        adaptive_conv(torch.from_numpy(src), torch.from_numpy(ker)).numpy(), got)


def test_adaptive_conv_bf16_promotes_like_jax():
    src = torch.from_numpy(_rand(3, 1, 10, 12, 4)).bfloat16()
    ker = torch.from_numpy(_rand(4, 1, 6, 8, 5, 5))
    out = adaptive_conv_fused_ref(src, ker)
    assert out.dtype == torch.float32
    assert adaptive_conv_fused_ref(src, ker.bfloat16()).dtype == torch.bfloat16


def test_adaptive_conv_gradient_matches_jax_vjp():
    src, ker = _rand(5, 2, 12, 14, 6), _rand(6, 2, 8, 10, 5, 5)
    cot = _rand(7, 2, 8, 10, 6)
    _, vjp = jax.vjp(j_ac.adaptive_conv, jnp.asarray(src), jnp.asarray(ker))
    want = vjp(jnp.asarray(cot))
    args = [torch.from_numpy(a).requires_grad_() for a in (src, ker)]
    got = torch.autograd.grad(adaptive_conv(*args), args, torch.from_numpy(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_adaptive_conv_wrapper_raises_off_cpu_and_cuda():
    src = torch.zeros(1, 10, 10, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        adaptive_conv_fused(src, torch.zeros(1, 8, 8, 3, 3, device="meta"))


def _perturbed(params, seed=9, s=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: a + s * np.asarray(rng.randn(*np.shape(a)), np.float32), params)


def _compare(jm, params, model, args_j, args_t, out):
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args_j), out))
    with torch.no_grad():
        got = model.eval()(*map(torch.from_numpy, args_t), out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _featup_params(c=16):
    """JAX FeatUp params with all four stages (initialized at ratio 16)."""
    jm = j_featup.FeatUp(feature_dim=c, ratio=16)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 2, 2, c)))
    return _perturbed(p["params"])


@pytest.mark.parametrize("ratio,lr", [(4, 8), (16, 2)])
def test_featup_matches_jax(ratio, lr):
    c = 16
    params = _featup_params(c)
    model = FeatUp(feature_dim=c, ratio=ratio)
    model.load_state_dict(featup_state_dict_from_jax(params))
    image, feats = _image(10, lr * ratio), _rand(11, 1, lr, lr, c)
    _compare(j_featup.FeatUp(feature_dim=c, ratio=ratio), params, model,
             (image, feats), (image, feats), (lr * ratio,) * 2)


def test_jbu_matches_jax():
    image, out = _image(12, 24), (32, 32)
    norm = (image - 0.45) / 0.22
    jm = j_featup.JBU()
    params = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(norm), jnp.asarray(image),
                                out)["params"])
    model = JBU()
    model.load_state_dict(jbu_state_dict_from_jax(params))
    _compare(jm, params, model, (norm, image), (norm, image), out)


def test_jbf_matches_jax():
    image = _image(13, 12)
    norm = (image - 0.45) / 0.22
    want = np.asarray(j_jbf.JBF().apply({}, jnp.asarray(norm), jnp.asarray(image), (32, 32)))
    got = JBF()(torch.from_numpy(norm), torch.from_numpy(image), (32, 32)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_anyup_matches_jax():
    image, feats, out = _image(14, 24), _rand(15, 1, 8, 8, 16), (32, 32)
    jm = j_anyup.AnyUpsampler()
    params = _perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(image), jnp.asarray(feats),
                                out)["params"])
    model = AnyUpsampler()
    model.load_state_dict(anyup_state_dict_from_jax(params))
    _compare(jm, params, model, (image, feats), (image, feats), out)


def test_jafar_matches_jax():
    image, feats, out = _image(16, 32), _rand(17, 1, 8, 8, 16), (24, 24)
    jm = j_jafar.JAFAR(v_dim=16)
    params = _perturbed(jm.init(jax.random.PRNGKey(3), jnp.asarray(image), jnp.asarray(feats),
                                out)["params"])
    model = JAFAR(v_dim=16)
    model.load_state_dict(jafar_state_dict_from_jax(params))
    _compare(jm, params, model, (image, feats), (image, feats), out)


@pytest.mark.parametrize("name", ["Bilinear", "Nearest"])
def test_simple_baselines_match_jax(name):
    image, feats = _image(18, 16), _rand(19, 1, 5, 7, 8)
    jm = getattr(j_simple, name)()
    want = np.asarray(jm.apply({}, jnp.asarray(image), jnp.asarray(feats), (23, 30)))
    model = {"Bilinear": Bilinear, "Nearest": Nearest}[name]()
    got = model(torch.from_numpy(image), torch.from_numpy(feats), (23, 30)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_featup_hub_remap_reads_the_ports_state_dict(tmp_path):
    """A hub checkpoint built from the port's state_dict() (ChannelNorm at
    model.1, a backbone key to drop) goes through naf_tpu's remap into JAX
    and through the port's remap into ModelWrapper; both models agree."""
    c = 16
    src = ModelWrapper("FeatUp", embed_dim=c, ratio=16, seed=4, device="cpu")
    hub = {"state_dict": {("model.1." + k[len("norm."):] if k.startswith("norm.") else k): v
                          for k, v in src.model.state_dict().items()}}
    hub["state_dict"]["model.0.backbone.ignored"] = torch.zeros(1)
    path = tmp_path / "featup.ckpt"
    torch.save(hub, path)
    loaded = ModelWrapper("FeatUp", embed_dim=c, ratio=16, checkpoint=str(path), device="cpu")
    for k, v in src.model.state_dict().items():
        torch.testing.assert_close(loaded.model.state_dict()[k], v, atol=0, rtol=0)

    params = j_featup.featup_params_from_torch(hub)
    image, feats = _image(20, 32), _rand(21, 1, 2, 2, c)
    want = np.asarray(j_featup.FeatUp(feature_dim=c, ratio=16).apply(
        {"params": params}, jnp.asarray(image), jnp.asarray(feats)))
    got = loaded(torch.from_numpy(image), torch.from_numpy(feats), (32, 32), channels_last=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _anyup_state(seed=22, dim=256):
    """An AnyUp state dict in the reference's encoder() naming (numpy)."""
    rng = np.random.RandomState(seed)
    state = {"encoder.0.weight": rng.randn(dim, 3, 3, 3).astype(np.float32) * 0.2,
             "encoder.0.bias": rng.randn(dim).astype(np.float32) * 0.1}
    for i in (1, 2):
        for n in ("norm1", "norm2"):
            state[f"encoder.{i}.{n}.weight"] = 1 + 0.1 * rng.randn(dim).astype(np.float32)
            state[f"encoder.{i}.{n}.bias"] = 0.1 * rng.randn(dim).astype(np.float32)
        for n in ("conv1", "conv2"):
            state[f"encoder.{i}.{n}.weight"] = rng.randn(dim, dim, 3, 3).astype(np.float32) * 0.02
            state[f"encoder.{i}.{n}.bias"] = 0.1 * rng.randn(dim).astype(np.float32)
    return state


def test_anyup_key_map_matches_jax_convert_checkpoint(tmp_path):
    state = _anyup_state()
    params = j_anyup.convert_checkpoint(state)
    path = tmp_path / "anyup.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    wrapper = ModelWrapper("AnyUp", checkpoint=str(path), device="cpu")
    image, feats, out = _image(23, 32), _rand(24, 1, 8, 8, 16), (32, 32)
    want = np.asarray(j_anyup.AnyUpsampler().apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(image), jnp.asarray(feats),
        out))
    got = wrapper(torch.from_numpy(image), torch.from_numpy(feats), out, channels_last=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same prefixes as the JAX converter, and its loud failures
    bare = {k[len("encoder."):]: v for k, v in state.items()}
    assert set(anyup_state_dict_from_torch(bare)) == set(anyup_state_dict_from_torch(state))
    with pytest.raises(KeyError, match="not consumed"):
        anyup_state_dict_from_torch({**state, "decoder.0.weight": state["encoder.0.weight"]})
    bad = dict(state)
    bad["encoder.1.conv1.weight"] = np.zeros((256, 16, 3, 3), np.float32)
    with pytest.raises(ValueError, match="conv1"):
        anyup_state_dict_from_torch(bad)
    with pytest.raises(KeyError, match="entry conv"):
        anyup_state_dict_from_torch({"decoder.weight": np.zeros(1)})


def test_registry_names_and_refusals(monkeypatch):
    names = ["AnyUp", "Bilinear", "FeatUp", "JAFAR", "JBF", "JBU", "NAF", "Nearest", "IRCNN",
             "REDNet", "Restormer"]
    for name in names:
        assert isinstance(build_model(name, embed_dim=16, ratio=4), torch.nn.Module)
    with pytest.raises(ValueError, match="Unknown upsampler"):
        build_model("NoSuchModel")
    register("Twice", lambda embed_dim, ratio: Bilinear())
    assert isinstance(build_model("Twice"), Bilinear)
    with pytest.raises(NotImplementedError, match="key map"):
        ModelWrapper("JAFAR", embed_dim=16, checkpoint="missing.pth", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelWrapper("Bilinear")


def test_model_wrapper_loads_a_naf_checkpoint(tmp_path):
    src = ModelWrapper("NAF", seed=5, device="cpu")
    state = {k: v.clone() for k, v in src.model.state_dict().items()}
    path = tmp_path / "naf.pth"
    torch.save({"state_dict": state}, path)
    loaded = ModelWrapper("NAF", checkpoint=str(path), device="cpu")
    for k, v in loaded.model.state_dict().items():
        torch.testing.assert_close(v, state[k], atol=0, rtol=0)


def test_model_wrapper_layouts_and_seeds():
    image, feats = _image(25, 32).transpose(0, 3, 1, 2), _rand(26, 1, 16, 8, 8)
    w = ModelWrapper("FeatUp", embed_dim=16, ratio=4, seed=1, device="cpu")
    nchw = w(image, feats, (32, 32))
    assert nchw.shape == (1, 16, 32, 32) and not nchw.requires_grad
    nhwc = w(image.transpose(0, 2, 3, 1), feats.transpose(0, 2, 3, 1), (32, 32),
             channels_last=True)
    torch.testing.assert_close(nchw.permute(0, 2, 3, 1), nhwc)
    again = ModelWrapper("FeatUp", embed_dim=16, ratio=4, seed=1, device="cpu")
    torch.testing.assert_close(again(image, feats, (32, 32)), nchw)
    other = ModelWrapper("FeatUp", embed_dim=16, ratio=4, seed=2, device="cpu")
    assert not torch.allclose(other(image, feats, (32, 32)), nchw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py holds K5 on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,k", [(2, 16, 32, 128, 7), (1, 14, 17, 3, 11),
                                       (2, 37, 53, 100, 5)])
def test_k5_kernel_matches_plain_on_card(cuda_device, b, h, w, c, k):
    src = torch.from_numpy(_rand(27, b, h + k - 1, w + k - 1, c)).to(cuda_device)
    ker = torch.from_numpy(_rand(28, b, h, w, k, k)).to(cuda_device)
    launches = adaptive_conv_fused.launches
    got = adaptive_conv_fused(src, ker)
    assert adaptive_conv_fused.launches == launches + 1
    torch.testing.assert_close(got, adaptive_conv_fused_ref(src, ker), **TOL)
