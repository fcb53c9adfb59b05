"""The self-distillation quality loop (naf_torch.evals.distill), the JAX
package's trained NAF carried across (naf_torch/assets/naf_distill_jax_ckpt3000.npz,
read by naf_torch.convert.naf_state_from_npz) and the trained weights
injected into the evals, against naf_tpu, f32 on the CPU.

The asset is the params of the JAX package's 3000-step self-distillation
run (``runs/distill_naf/version_2/ckpt_3000``, an orbax checkpoint written
on a TPU), saved with the flax tree's paths joined by ``/``. It was written
by this file's helper, and a test derives it again:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_distill.py   # rewrites the asset

Bars: atol = rtol = 2e-4 (f32); the asset and the checkpoint bit for bit.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naf_torch.convert import (
    JAX_DISTILLED_NPZ,
    naf_params_from_npz,
    naf_state_from_npz,
    state_dict_from_jax_params,
)
from naf_torch.data.device_cache import index_batches
from naf_torch.evals import distill, seg_probing
from naf_torch.models.naf import NAF
from naf_tpu.models.naf import NAF as JNAF

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)
REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "runs" / "distill_naf" / "version_2" / "ckpt_3000"
PHOTO = REPO / "benchmarks" / "real_shard" / "ade20k" / "images" / "training"
TINY_BACKBONE = ["backbone.depth=1", "backbone.embed_dim=64", "backbone.num_heads=2"]


def jax_distilled_params() -> dict:
    """The checkpoint's params as numpy arrays (every leaf restored as
    ``np.ndarray``: the checkpoint names a TPU, which a CPU restore of jax
    arrays cannot find)."""
    import orbax.checkpoint as ocp

    ckpt = ocp.PyTreeCheckpointer()
    meta = ckpt.metadata(str(CKPT)).item_metadata.tree
    args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta)
    return ckpt.restore(str(CKPT), restore_args=args)["params"]


def flat(tree, leaf_fn=np.asarray) -> dict:
    return {"/".join(k.key for k in path): leaf_fn(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def write_asset(path=JAX_DISTILLED_NPZ) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: v.astype(np.float32) for k, v in flat(jax_distilled_params()).items()})


def _jax_tree() -> dict:
    return jax.tree.map(jnp.asarray, naf_params_from_npz())


# ------------------------------------------------------------- the asset ----


def test_asset_is_the_checkpoint_bit_for_bit():
    """The npz holds the orbax checkpoint's params, every leaf f32 and
    bitwise equal, under the paths of naf_tpu's ``NAF()`` tree (its
    ``init`` traced, not run), and loads into the port's ``NAF()`` with
    every name checked."""
    want = flat(jax_distilled_params())
    with np.load(JAX_DISTILLED_NPZ) as npz:
        got = {k: npz[k] for k in npz.files}
    assert sorted(got) == sorted(want) and len(got) == 36
    for k, v in want.items():
        assert got[k].dtype == np.float32 and v.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    shapes = jax.eval_shape(lambda: JNAF().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                jnp.zeros((1, 4, 4, 384)), (64, 64)))["params"]
    assert flat(shapes, lambda a: a.shape) == {k: v.shape for k, v in got.items()}
    assert sum(v.size for v in got.values()) == 662_528
    model = NAF()
    state = naf_state_from_npz()
    assert model.load_state_dict(state, strict=True) is not None
    assert set(state) == set(model.state_dict())


def test_asset_writer_derives_the_same_arrays(tmp_path):
    """The committed asset, written again from the checkpoint, holds the
    same arrays under the same keys."""
    write_asset(tmp_path / "again.npz")
    with np.load(tmp_path / "again.npz") as a, np.load(JAX_DISTILLED_NPZ) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def _photo(size):
    from naf_torch.data.transforms import image_transform
    from PIL import Image

    path = sorted(PHOTO.iterdir())[0]
    return image_transform(Image.open(path).convert("RGB"), size)[None]


@pytest.mark.parametrize("na_impl", ["auto", "xla"], ids=["fused", "modular"])
def test_trained_naf_matches_jax_on_a_real_photo(na_impl):
    """The JAX-trained weights in the port's fused (the kernels' plain
    versions on the CPU) and modular forwards against naf_tpu's XLA path, on
    a real-shard photo at 64^2 (ImageNet-normalised) with seeded 4^2 x 384
    features, to 64^2."""
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    image = ((_photo(64) - mean) / std).astype(np.float32)
    feats = np.random.RandomState(0).randn(1, 4, 4, 384).astype(np.float32)
    want = np.asarray(JNAF(na_impl="xla").apply({"params": _jax_tree()}, jnp.asarray(image),
                                                jnp.asarray(feats), (64, 64)))
    model = NAF(na_impl=na_impl).eval()
    model.load_state_dict(naf_state_from_npz())
    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(feats), (64, 64)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------- injected weights ----


def _port_vit_state(params, cfg) -> dict:
    """The JAX ViT's params as the port's timm-named state dict."""
    p = jax.tree.map(np.asarray, params)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    c = cfg.embed_dim
    st = {"patch_embed.proj.weight": t(p["patch_embed"]["kernel"].transpose(3, 2, 0, 1)),
          "patch_embed.proj.bias": t(p["patch_embed"]["bias"]), "cls_token": t(p["cls_token"]),
          "pos_embed": t(p["pos_embed"]), "norm.weight": t(p["norm"]["scale"]),
          "norm.bias": t(p["norm"]["bias"])}
    for i in range(cfg.depth):
        b, q = p[f"block{i}"], f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            st[f"{q}.{norm}.weight"], st[f"{q}.{norm}.bias"] = (t(b[norm]["scale"]),
                                                                t(b[norm]["bias"]))
        st[f"{q}.attn.qkv.weight"] = t(b["attn"]["qkv"]["kernel"].reshape(c, 3 * c).T)
        st[f"{q}.attn.qkv.bias"] = t(b["attn"]["qkv"]["bias"].reshape(-1))
        st[f"{q}.attn.proj.weight"] = t(b["attn"]["proj"]["kernel"].reshape(c, c).T)
        st[f"{q}.attn.proj.bias"] = t(b["attn"]["proj"]["bias"])
        for fc in ("fc1", "fc2"):
            st[f"{q}.mlp.{fc}.weight"] = t(b[fc]["kernel"].T)
            st[f"{q}.mlp.{fc}.bias"] = t(b[fc]["bias"])
        for ls in ("ls1", "ls2"):
            st[f"{q}.{ls}.gamma"] = t(b[ls])
    return st


def test_probe_feature_fn_with_injected_state_matches_jax():
    """``seg_probing.build_models(cfg, model_state)`` + ``build_feature_fn``
    against ``evaluation/eval_seg_probing.build_feature_fn(..., model_params)``
    with the JAX-trained params, on one full ViT-S/16 drawn by the JAX
    wrapper and converted into the port's."""
    import importlib.util

    from naf_torch.config import load_config
    from naf_tpu.backbones import PretrainedViTWrapper as JWrapper

    spec = importlib.util.spec_from_file_location("eval_seg_probing",
                                                  REPO / "evaluation" / "eval_seg_probing.py")
    jeval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jeval)
    jbackbone = JWrapper("vit_small_patch16_224")
    cfg = load_config("eval_probing", [*distill.seg_args("naf"), "device=cpu", "img_size=64"])
    backbone, model, dtype, _ = seg_probing.build_models(cfg, naf_state_from_npz())
    backbone.model.load_state_dict(_port_vit_state(jbackbone.params, backbone.vit_config))
    image = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jeval.build_feature_fn(cfg, jbackbone, JNAF(na_impl="xla"), _jax_tree())(
        jnp.asarray(image), (48, 48)))
    with torch.no_grad():
        got = seg_probing.build_feature_fn(backbone, model, dtype)(torch.from_numpy(image),
                                                                    (48, 48)).numpy()
    assert got.shape == want.shape == (2, 48, 48, 384)
    np.testing.assert_allclose(got, want, **TOL)


def test_build_models_loads_the_state_strictly():
    from naf_torch.config import load_config

    cfg = load_config("eval_probing", [*distill.seg_args("naf"), "device=cpu", *TINY_BACKBONE])
    _, model, _, _ = seg_probing.build_models(cfg, naf_state_from_npz())
    for k, v in naf_state_from_npz().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    assert not any(p.requires_grad for p in model.parameters())
    small = load_config("eval_probing", [*distill.seg_args("naf"), "device=cpu", "model.dim=32"])
    with pytest.raises(RuntimeError, match="size mismatch"):
        seg_probing.build_models(small, naf_state_from_npz())


def test_video_seg_main_runs_the_injected_state(tmp_path, monkeypatch):
    """``video_seg.main(argv, model_state)``: the upsampler handed to
    ``run_video`` is ``NAF()`` with the injected weights (its output equals
    the JAX-trained model's), over each video of the split."""
    from naf_torch.evals import video_seg, video_seg_runner

    from PIL import Image

    davis = tmp_path / "davis"
    (davis / "ImageSets" / "2017").mkdir(parents=True)
    (davis / "ImageSets" / "2017" / "val.txt").write_text("s\n")
    (davis / "Annotations" / "480p" / "s").mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8), np.uint8), mode="P").save(
        davis / "Annotations" / "480p" / "s" / "00000.png")
    seen = []

    def run_video(backbone, upsampler_fn, frames, first_mask, out_dir, **kw):
        os.makedirs(os.path.dirname(out_dir), exist_ok=True)
        image = torch.from_numpy(np.random.RandomState(2).randn(1, 32, 32, 3).astype(np.float32))
        feats = torch.from_numpy(np.random.RandomState(3).randn(1, 4, 4, 64).astype(np.float32))
        seen.append((out_dir, upsampler_fn(image, feats, (32, 32))))

    monkeypatch.setattr(video_seg_runner, "run_video", run_video)
    monkeypatch.setattr(video_seg_runner, "evaluate_davis_results",
                        lambda *a: ({"J&F-Mean": 0.5}, {}))
    summary = video_seg.main(["model=naf", f"dataset.root={davis}", f"run_dir={tmp_path / 'r'}",
                              "device=cpu", *TINY_BACKBONE], model_state=naf_state_from_npz())
    assert summary == {"J&F-Mean": 0.5} and len(seen) == 1
    assert seen[0][0] == str(tmp_path / "r" / "davis_vidseg_1_naf" / "s")
    model = NAF().eval()
    model.load_state_dict(naf_state_from_npz())
    image = torch.from_numpy(np.random.RandomState(2).randn(1, 32, 32, 3).astype(np.float32))
    feats = torch.from_numpy(np.random.RandomState(3).randn(1, 4, 4, 64).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(seen[0][1], model(image, feats, (32, 32)), rtol=0, atol=0)


def test_npz_reader_takes_any_naf_tree(tmp_path):
    """A JAX ``NAF(dim=32, heads_rope=2, img_layers=1)``'s params written
    as the asset is written read back to the converter's state dict."""
    params = JNAF(dim=32, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=1).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 4, 4, 8)), (16, 16))
    np.savez(tmp_path / "p.npz", **flat(params["params"]))
    got = naf_state_from_npz(tmp_path / "p.npz", img_layers=1, heads_rope=2)
    want = state_dict_from_jax_params(params["params"], img_layers=1, heads_rope=2)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    NAF(dim=32, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=1).load_state_dict(got)


def test_launches_since_reads_each_counter():
    """``naf_torch.kernels.launches_since``: the difference of two
    readings of every wrapper's counter (K4's backward counter for K4)."""
    from naf_torch.kernels import launch_counts, launches_since
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused

    before = launch_counts()
    assert set(before) == {"k1", "k2", "k3", "k4", "k4_chunked", "k5", "k6", "keys", "stem"}
    gn_silu_conv_fused.launches += 3
    cross_scale_na2d_fused.bwd_launches += 2
    cross_scale_na2d_fused.route_launches["wgmma_chunked_bwd"] += 1
    try:
        assert launches_since(before) == {"k1": 3, "k2": 0, "k3": 0, "k4": 2, "k4_chunked": 1,
                                          "k5": 0, "k6": 0, "keys": 0, "stem": 0}
    finally:
        gn_silu_conv_fused.launches -= 3
        cross_scale_na2d_fused.bwd_launches -= 2
        cross_scale_na2d_fused.route_launches["wgmma_chunked_bwd"] -= 1


# ---------------------------------------------------------------- training ----


def _fake_chunks(calls):
    """A ``make_train_chunk`` stand-in for both packages: records each
    chunk's indices, first step and lr size, and returns zero losses."""
    def make(*args, **kwargs):
        def chunk(*a):
            if len(a) == 8:  # JAX: (params, opt_state, stack, idx, step0, lr, out, crop)
                params, opt_state, _, idx, step0, lr_size = a[:6]
                calls.append((np.asarray(idx).tolist(), int(step0), tuple(lr_size)))
                return params, opt_state, jnp.zeros(len(idx))
            _, idx, step0, lr_size = a[:4]
            calls.append((np.asarray(idx).tolist(), int(step0), tuple(lr_size)))
            return torch.zeros(len(idx))
        return chunk
    return make


def test_lr_size_per_chunk_is_drawn_as_jax_draws_it(tmp_path, monkeypatch):
    """The device-stack route of both trainers at the quality loop's
    settings (256^2, batch 4, ``down_factor="random"``, 100 steps a chunk,
    seed 0) over 60 images: the same batch indices and the same lr size for
    every chunk, from the same ``RandomState``; the chunks' compute stubbed
    out."""
    import naf_torch.train.trainer as ttrain
    import naf_tpu.train.trainer as jtrain
    from naf_torch.backbones import PretrainedViTWrapper
    from naf_tpu.backbones import PretrainedViTWrapper as JWrapper

    got, want = [], []
    monkeypatch.setattr(ttrain, "make_train_chunk", _fake_chunks(got))
    monkeypatch.setattr(jtrain, "make_train_chunk", _fake_chunks(want))
    kw = dict(train_steps=1050, img_size=256, batch_size=4, down_factor="random",
              log_every=100, viz_every=0, ckpt_every=2000)
    small = dict(num_heads=2, embed_dim=64, depth=1)
    ttrain.train_upsampler(NAF(dim=32, heads_attn=2, heads_rope=2, kernel_size=5),
                           PretrainedViTWrapper("vit_small_patch16_224", device="cpu", **small),
                           None, ttrain.TrainConfig(**kw, log_dir=str(tmp_path / "t")),
                           device="cpu", device_stack=torch.zeros(60, 256, 256, 3))
    jtrain.train_upsampler(JNAF(dim=32, heads_attn=2, heads_rope=2, kernel_size=5),
                           JWrapper("vit_small_patch16_224", **small), None,
                           jtrain.TrainConfig(**kw, log_dir=str(tmp_path / "j")),
                           device_stack=jnp.zeros((60, 256, 256, 3)))
    assert len(got) == len(want) == 11 and got == want
    assert [c[1] for c in got] == list(range(0, 1001, 100))
    assert len({c[2] for c in got}) > 3  # the draws vary from chunk to chunk
    recs = [json.loads(line) for line in open(tmp_path / "t" / "version_0" / "metrics.jsonl")]
    assert [tuple(r["lr_size"]) for r in recs] == [c[2] for c in want]
    assert all(r["loss_median"] == 0 and r["chunk_s"] >= 0 for r in recs)
    # the JAX package stacks a chunk's batches after drawing them all, and
    # each batch is a view of the one permutation array that every epoch
    # reshuffles: a chunk of 100 steps over 15 batches an epoch takes the
    # batches of its last epoch's permutation, as the port does
    order = index_batches(60, 4, rng=np.random.RandomState(0))
    first = np.stack([next(order) for _ in range(100)])
    assert got[0][0] == first.tolist() and len({tuple(b) for b in got[0][0]}) == 15


def _tiny_ade(root, n_train=4, n_val=1):
    """An ADE20K layout of random photographs and 7-class labels."""
    from PIL import Image

    rng = np.random.RandomState(3)
    for split, n in (("training", n_train), ("validation", n_val)):
        for i in range(n):
            for sub, arr in (("images", (rng.rand(40, 52, 3) * 255).astype(np.uint8)),
                             ("annotations", rng.randint(0, 7, (40, 52)).astype(np.uint8))):
                path = root / sub / split / f"a_{i}.{'jpg' if sub == 'images' else 'png'}"
                path.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(arr).save(path)


def test_distill_cli_runs_on_the_cpu(tmp_path, capsys):
    """``python -m naf_torch.evals.distill 4 --no-davis device=cpu ...``:
    full-width ``NAF()`` (the JAX weights must load) and a one-layer
    ViT-S/16 at 144^2 on a four-photograph ADE20K layout, 4 training steps
    in one chunk, one probe epoch (labels and features at 48^2) on the
    trained and on the JAX weights; the
    JSON and the run under ``tmp_path``, nothing under ``benchmarks/`` or
    ``runs/``."""
    before = {d: sorted((REPO / d).rglob("*")) for d in ("benchmarks", "runs")}
    _tiny_ade(tmp_path / "ade")
    out = tmp_path / "out" / "distilled.json"
    res = distill.main(["4", "--no-davis", "device=cpu", "num_epochs=1", "img_size=144",
                        "target_size=48", *TINY_BACKBONE, f"dataset.root={tmp_path / 'ade'}",
                        f"out={out}"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    train = res["train"]
    assert train["train_steps"] == 4 and train["photos"] == 4 and len(train["chunks"]) == 1
    chunk = train["chunks"][0]
    assert np.isfinite(chunk["loss"]) and np.isfinite(chunk["loss_median"])
    assert train["step_ms"] > 0 and set(train["launches"].values()) == {0}
    assert res["tf32"] is False and Path(train["log_dir"]) == tmp_path / "out" / "distill_naf"
    (log,) = Path(train["log_dir"]).glob("version_*")
    assert (log / "ckpt_4.pt").exists()
    assert [json.loads(line) for line in open(log / "metrics.jsonl")] == train["chunks"]
    for key in ("seg_probing_naf_distilled", "seg_probing_naf_jax_ckpt3000"):
        assert 0 <= res[key]["iou"] <= res[key]["accuracy"] <= 1 and len(res[key]["epoch_s"]) == 1
    assert res["seg_probing_naf_distilled"]["train_steps"] == 4
    assert "davis_jf_naf_distilled" not in res
    assert "seg_probing_naf_jax_ckpt3000: iou" in capsys.readouterr().out
    assert {d: sorted((REPO / d).rglob("*")) for d in ("benchmarks", "runs")} == before


@pytest.mark.parametrize("tf32", [False, True])
def test_distill_cli_sets_and_records_its_own_tf32(tf32, tmp_path, monkeypatch):
    """The CLI's training and every probe run with cuDNN's and cuBLAS's TF32
    as ``--tf32`` says (off without it), the JSON records it, and the
    caller's switches come back after it (the work itself stubbed)."""
    seen, caller = [], (not tf32, tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller[0])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller[1])
    switches = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def train(cfg, steps, log_dir):
        seen.append(switches())
        return {}, {"train_s": 1.0, "step_ms": 1.0, "launches": {"k1": 0}}

    def probe(argv, model_state):
        seen.append(switches())
        return {"iou": 0.5, "accuracy": 0.6, "epoch_s": [1.0]}

    monkeypatch.setattr(distill, "train_distilled", train)
    monkeypatch.setattr(seg_probing, "main", probe)
    out = tmp_path / "d.json"
    res = distill.main(["2", "--no-davis", "device=cpu", f"out={out}"]
                       + (["--tf32"] if tf32 else []))
    assert seen == [(tf32, tf32)] * 3 and switches() == caller
    assert res["tf32"] is tf32 and json.loads(out.read_text())["tf32"] is tf32


if __name__ == "__main__":
    write_asset()
    print(f"wrote {JAX_DISTILLED_NPZ} ({os.path.getsize(JAX_DISTILLED_NPZ)} bytes)")
