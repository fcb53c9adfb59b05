"""The port's evaluation path (naf_torch.evals.seg_probing / video_seg /
video_seg_runner, the segmentation datasets, the CLIs) against naf_tpu, on
the CPU, from the same numpy inputs and weights.

Bars: the probe's losses and weights after an epoch at atol = rtol = 2e-4
(JAX's initial weights injected); label propagation at atol 1e-5 / rtol
1e-4 (the JAX package's own bar against its torch transcription); the
metrics, the dataset items and the propagated masks exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from naf_torch.backbones import PretrainedViTWrapper, ViT, ViTConfig
from naf_torch.convert import state_dict_from_jax_params
from naf_torch.data import datasets as tdata
from naf_torch.data import transforms as ttf
from naf_torch.evals import real_shard, seg_probing
from naf_torch.evals import video_seg as tvs
from naf_torch.evals import video_seg_runner as trun
from naf_torch.models.naf import NAF
from naf_tpu.backbones import PretrainedViTWrapper as JWrapper
from naf_tpu.data import datasets as jdata
from naf_tpu.data import transforms as jtf
from naf_tpu.evals import seg_probing as jseg
from naf_tpu.evals import video_seg as jvs
from naf_tpu.evals import video_seg_runner as jrun
from naf_tpu.models.naf import NAF as JNAF

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
SMALL_NAF = dict(dim=32, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=1)
TINY = ["device=cpu", "model.dim=32", "model.heads_attn=2", "model.heads_rope=2",
        "model.kernel_size=5", "model.img_layers=1", "backbone.depth=1",
        "backbone.embed_dim=64", "backbone.num_heads=2"]


def test_seg_metrics_match_jax():
    rng = np.random.RandomState(0)
    pred, target = rng.randint(0, 6, 500), rng.randint(0, 5, 500)  # class 5 never a target
    got, want = seg_probing.SegMetrics(6), jseg.SegMetrics(6)
    for m in (got, want):
        m.update(pred[:300], target[:300])
        m.update(pred[300:], target[300:])
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.compute() == want.compute()
    assert seg_probing.SegMetrics(3).compute() == jseg.SegMetrics(3).compute()


def test_linear_probe_epoch_matches_jax():
    """Per-step losses, the weights after 6 AdamW steps under the cosine
    decay (horizon 8, so it bends), one flip draw per batch, features at
    half the label size resized bilinearly, and the evaluation."""
    rng = np.random.RandomState(1)
    dim, n_cls = 16, 5
    proj = rng.randn(3, dim).astype(np.float32)
    batches = []
    for _ in range(6):
        image = rng.rand(2, 8, 8, 3).astype(np.float32)
        label = rng.randint(0, n_cls, (2, 8, 8)).astype(np.int32)
        label[:, :2, :3] = 255
        batches.append((image, label))

    def jfeat(image, hw):
        return jnp.tanh(image[:, ::2, ::2] @ jnp.asarray(proj))

    def tfeat(image, hw):
        return torch.tanh(image[:, ::2, ::2] @ torch.from_numpy(proj))

    cfg = dict(num_classes=n_cls, num_epochs=2, lr=5e-2, steps_per_epoch=4)
    jprobe = jseg.LinearProbe(jfeat, dim, jseg.ProbeConfig(**cfg))
    probe = seg_probing.LinearProbe(tfeat, dim, seg_probing.ProbeConfig(**cfg), device="cpu")
    probe.set_weights(np.array(jprobe.params["kernel"]), np.array(jprobe.params["bias"]))
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    for batch in batches:  # an epoch, one batch per call to see each step's loss
        want = jprobe.train_epoch([batch], jrng)
        got = probe.train_epoch([batch], trng)
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(probe.kernel.detach().numpy(), np.asarray(jprobe.params["kernel"]),
                               **TOL)
    np.testing.assert_allclose(probe.bias.detach().numpy(), np.asarray(jprobe.params["bias"]),
                               **TOL)
    assert probe.evaluate(batches) == jprobe.evaluate(batches)


def test_probe_draws_its_weights_from_the_seed():
    a = seg_probing.LinearProbe(None, 8, seg_probing.ProbeConfig(num_classes=3, seed=4),
                                device="cpu")
    b = seg_probing.LinearProbe(None, 8, seg_probing.ProbeConfig(num_classes=3, seed=4),
                                device="cpu")
    torch.testing.assert_close(a.kernel, b.kernel, rtol=0, atol=0)
    assert float(a.kernel.detach().abs().max()) <= 8 ** -0.5 and not a.bias.any()
    assert a.opt.defaults["weight_decay"] == 1e-4


def _strict_topk_propagation(feat_tar, feat_sources, segs, h, w, size_mask, topk):
    """Exactly k entries per query (torch.topk's indices), for contrast."""
    ft = torch.nn.functional.normalize(torch.from_numpy(feat_tar), dim=1)
    fs = torch.nn.functional.normalize(torch.from_numpy(feat_sources), dim=1)
    aff = torch.exp(torch.einsum("qc,ncs->nqs", ft, fs) / 0.1)
    aff = aff * torch.from_numpy(tvs.restrict_neighborhood(h, w, size_mask))[None]
    aff = aff.transpose(1, 2).reshape(-1, h * w)
    idx = torch.topk(aff, topk, dim=0).indices
    kept = torch.zeros_like(aff).scatter_(0, idx, aff.gather(0, idx))
    kept = kept / kept.sum(0, keepdim=True)
    k = segs.shape[1]
    return (torch.from_numpy(segs).transpose(0, 1).reshape(k, -1) @ kept).reshape(k, h, w)


def test_label_propagation_keeps_ties_as_jax_does():
    """Two context frames with equal features plant a tie at every query's
    k-th affinity (k odd, each value twice): the threshold keeps both,
    top-k's indices keep one."""
    rng = np.random.RandomState(2)
    h, w, c, k = 5, 6, 8, 3
    feat_tar = rng.randn(h * w, c).astype(np.float32)
    frame = rng.randn(c, h * w).astype(np.float32)
    feat_sources = np.stack([frame, frame, rng.randn(c, h * w).astype(np.float32)])
    segs = rng.rand(3, k, h * w).astype(np.float32)
    size_mask, topk = 2, 3
    want = np.asarray(jvs.label_propagation(jnp.asarray(feat_tar), jnp.asarray(feat_sources),
                                            jnp.asarray(segs), h, w, size_mask=size_mask,
                                            topk=topk))
    got = tvs.label_propagation(torch.from_numpy(feat_tar), torch.from_numpy(feat_sources),
                                torch.from_numpy(segs), h, w, size_mask=size_mask, topk=topk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    strict = _strict_topk_propagation(feat_tar, feat_sources, segs, h, w, size_mask, topk)
    assert np.abs(strict.numpy() - want).max() > 1e-3
    np.testing.assert_array_equal(tvs.restrict_neighborhood(h, w, 2),
                                  jvs.restrict_neighborhood(h, w, 2))
    mask = rng.randn(3, 4, 5).astype(np.float32)
    mask[1] = -np.abs(mask[1])  # a channel with no positive maximum stays as it is
    np.testing.assert_allclose(tvs.norm_mask(torch.from_numpy(mask)).numpy(),
                               np.asarray(jvs.norm_mask(jnp.asarray(mask))), rtol=1e-6, atol=1e-6)


def test_j_and_f_match_jax():
    rng = np.random.RandomState(3)
    gt = np.zeros((6, 30, 40), bool)
    gt[:, 8:22, 10:30] = True
    pred = np.roll(gt, 3, axis=-1) ^ (rng.rand(*gt.shape) < 0.05)
    pred[2] = False  # an empty prediction
    for fn in ("davis_eval_iou", "davis_eval_boundary"):
        np.testing.assert_array_equal(getattr(tvs, fn)(gt, pred), getattr(jvs, fn)(gt, pred))
    np.testing.assert_array_equal(tvs.davis_eval_boundary(gt[0], pred[0]),
                                  jvs.davis_eval_boundary(gt[0], pred[0]))
    per_frame = tvs.davis_eval_iou(gt, pred)
    assert tvs.davis_statistics(per_frame) == jvs.davis_statistics(per_frame)


# ------------------------------------------------------------------ video ----


def _write_davis(root, seq="seq", n=3, hw=(50, 70)):
    """A DAVIS layout of one 3-frame sequence: frames off the patch grid,
    an indexed annotation of three labels per frame."""
    rng = np.random.RandomState(4)
    frames, masks = root / "JPEGImages" / "480p" / seq, root / "Annotations" / "480p" / seq
    frames.mkdir(parents=True)
    masks.mkdir(parents=True)
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text(f"{seq}\n")
    palette = list(rng.randint(0, 255, 768))
    for i in range(n):
        img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        img[10 + 3 * i: 30 + 3 * i, 15:45] = (250, 40, 40)
        Image.fromarray(img).save(frames / f"{i:05d}.jpg")
        lbl = np.zeros(hw, np.uint8)
        lbl[10 + 3 * i: 30 + 3 * i, 15:45] = 1
        lbl[35:, 50:] = 2
        m = Image.fromarray(lbl, mode="P")
        m.putpalette(palette)
        m.save(masks / f"{i:05d}.png")
    return sorted(str(p) for p in frames.iterdir()), str(masks / "00000.png")


def _backbones(tmp_path):
    """The port's and the JAX package's wrappers on one small timm checkpoint
    (a 2 x 2 grid with a cls position: both packages read it alike)."""
    vit = ViT(ViTConfig(patch_size=16, embed_dim=64, depth=1, num_heads=2, pos_grid=2))
    vit.reset_parameters(torch.Generator().manual_seed(0))
    path = tmp_path / "vit.pth"
    torch.save(vit.state_dict(), path)
    return (PretrainedViTWrapper("vit_small_patch16_224", checkpoint=str(path), num_heads=2,
                                 device="cpu"),
            _Jitted(JWrapper("vit_small_patch16_224", checkpoint=str(path), num_heads=2)))


class _Jitted:
    """A JAX wrapper whose forward runs as one compiled program (eager
    flax compiles every operation on its own, which is slow)."""

    def __init__(self, wrapper):
        self.config = wrapper.config
        self._fn = jax.jit(wrapper.__call__)

    def __call__(self, image):
        return self._fn(image)


def test_run_video_matches_jax(tmp_path):
    frames, first = _write_davis(tmp_path / "davis")
    tbb, jbb = _backbones(tmp_path)
    jm = JNAF(na_impl="xla", **SMALL_NAF)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 4, 4, 64)),
                     (32, 32))["params"]
    model = NAF(**SMALL_NAF).eval()
    model.load_state_dict(state_dict_from_jax_params(params, img_layers=1, heads_rope=2))

    japply = jax.jit(lambda img, feats, hw: jm.apply({"params": params}, img, feats, hw),
                     static_argnums=2)

    def jfn(img, feats, hw):
        return japply(img, feats, tuple(hw))

    @torch.no_grad()
    def tfn(img, feats, hw):
        return model(img, feats, tuple(hw))

    kw = dict(ups_factor=2, n_last_frames=1, size_mask=2, topk=3)
    jrun.run_video(jbb, jfn, frames, first, str(tmp_path / "jax" / "seq"), **kw)
    trun.run_video(tbb, tfn, frames, first, str(tmp_path / "port" / "seq"), **kw)
    for i in range(3):
        got = np.asarray(Image.open(tmp_path / "port" / "seq" / f"{i:05d}.png"))
        want = np.asarray(Image.open(tmp_path / "jax" / "seq" / f"{i:05d}.png"))
        assert got.shape == (50, 70)
        np.testing.assert_array_equal(got, want)
    got = trun.evaluate_davis_results(str(tmp_path / "davis"), str(tmp_path / "port"))
    assert got == jrun.evaluate_davis_results(str(tmp_path / "davis"), str(tmp_path / "jax"))


# ---------------------------------------------------------------- datasets ----


def _save(path, arr, mode=None):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr, mode=mode).save(path)


def _img(rng, h=40, w=52):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


def _lbl(rng, hi, h=40, w=52):
    return rng.randint(0, hi, (h, w)).astype(np.uint8)


def _ade(root, rng):
    for split in ("training", "validation"):
        for i in range(2):
            _save(root / "images" / split / f"a_{i}.jpg", _img(rng))
            _save(root / "annotations" / split / f"a_{i}.png", _lbl(rng, 151))
    return dict(split="val")


def _cityscapes(root, rng):
    for i in range(2):
        _save(root / "leftImg8bit" / "train" / "aachen" / f"x{i}_leftImg8bit.png", _img(rng))
        _save(root / "gtFine" / "train" / "aachen" / f"x{i}_gtFine_labelIds.png", _lbl(rng, 40))
    return dict(split="train")


def _coco(root, rng):
    for i in range(2):
        _save(root / "images" / "val2017" / f"{i}.jpg", _img(rng))
        lbl = _lbl(rng, 190)
        lbl[:3] = 255
        _save(root / "annotations" / "val2017" / f"{i}.png", lbl)
    return dict(split="val")


def _voc(root, rng):
    base = root / "VOCdevkit" / "VOC2012"
    for i in range(2):
        _save(base / "JPEGImages" / f"v{i}.jpg", _img(rng))
        _save(base / "SegmentationClass" / f"v{i}.png", _lbl(rng, 21))
    (base / "ImageSets" / "Segmentation").mkdir(parents=True)
    (base / "ImageSets" / "Segmentation" / "train.txt").write_text("v0\nv1\n")
    return dict(split="train")


def _kitti(root, rng):
    for i in range(5):
        _save(root / "data_2d_raw" / "seq0" / "image_00" / "data_rect" / f"{i}.png", _img(rng))
        _save(root / "data_2d_semantics" / "train" / "seq0" / "image_00" / "semantic" / f"{i}.png",
              _lbl(rng, 40))
    return dict(split="val", split_file=str(root / "split.json"))


def _davis(root, rng):
    for i in range(2):
        _save(root / "JPEGImages" / "480p" / "s" / f"{i:05d}.jpg", _img(rng))
        _save(root / "Annotations" / "480p" / "s" / f"{i:05d}.png", _lbl(rng, 3), mode="P")
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text("s\n")
    return dict(split="val")


DATASETS = {"ADE20KDataset": _ade, "CityscapesDataset": _cityscapes, "COCOStuffDataset": _coco,
            "VOCDataset": _voc, "KITTI360Dataset": _kitti, "DAVISFramesDataset": _davis}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_reader_matches_jax(tmp_path, name):
    kw = DATASETS[name](tmp_path, np.random.RandomState(5))
    got = getattr(tdata, name)(str(tmp_path), transform=lambda im: ttf.image_transform(im, 32),
                               target_transform=lambda lb: ttf.label_transform(lb, 32), **kw)
    want = getattr(jdata, name)(str(tmp_path), transform=lambda im: jtf.image_transform(im, 32),
                                target_transform=lambda lb: jtf.label_transform(lb, 32), **kw)
    assert len(got) == len(want) > 0 and got.pairs == want.pairs
    for i in range(len(got)):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
        assert a["label"].dtype == b["label"].dtype and a["image"].shape == (32, 32, 3)


# ------------------------------------------------------------------- CLIs ----


def test_seg_probing_cli_runs_synthetic_on_the_cpu(capsys):
    out = seg_probing.main(["synthetic=true", "num_epochs=1", "img_size=28", *TINY])
    assert set(out) == {"accuracy", "iou", "epoch_s"} and 0 <= out["iou"] <= out["accuracy"] <= 1
    assert "epoch 0: loss" in capsys.readouterr().out


def test_real_shard_cli_runs_one_epoch_on_the_cpu(tmp_path):
    """The committed real shard through the port's CLIs at
    ``evaluation/eval_real_shard.py``'s arguments, cut to one epoch, 32^2 and
    a tiny backbone and NAF, writing only under ``tmp_path``."""
    path = tmp_path / "real_eval.json"
    res = real_shard.main(["num_epochs=1", "img_size=32", *TINY, f"out={path}",
                           f"run_dir={tmp_path / 'runs'}"])
    assert json.loads(path.read_text()) == json.loads(json.dumps(res))
    for key in ("seg_probing_naf", "seg_probing_bilinear"):
        assert 0 <= res[key]["iou"] <= 1 and len(res[key]["epoch_s"]) == 1
    assert 0 <= res["davis_jf_naf"]["J&F-Mean"] <= 1
    written = os.listdir(tmp_path / "runs" / "davis_vidseg_2_naf")
    assert {"china_pan", "flower_pan", "results.json"} <= set(written)
