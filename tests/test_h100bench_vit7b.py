"""The cells ``naf-dinov3-vit7b16.512`` and ``naf-dinov3-s16.512to4096`` on
the CPU at small sizes, against their own limits: sound bf16 runs pass; the
float8 control and each fault of ``h100bench.calibrate_large.FAULTS``,
planted under the harness's timed path, fail. Also the references they are
held to (the row-blocked NAF against the whole one, the ViT-7B's work
against ``FlopCounterMode``) and that a program without the published shape
fails before it draws a weight. No JAX."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import calibrate_large, check, run, work_vit
from h100bench.reference import dinov3_vit
from h100bench.reference import naf as ref_naf
from h100bench.reference.naf_rows import naf_rows
from h100bench.weights import draw, naf_specs
from h100bench.weights_dinov3 import dinov3_specs, draw_parts

torch.set_num_threads(1)
CONFIGS = Path(__file__).resolve().parents[1] / "h100bench" / "configs"
VIT_CELL, STREAMED_CELL = "naf-dinov3-vit7b16.512", "naf-dinov3-s16.512to4096"
SEED = 2**31 + 2026
NAF_SMALL = {"dim": 32, "heads_attn": 2, "heads_rope": 2, "kernel_size": 3, "img_layers": 1}
VFM = {"kind": "vfm_upsample", "batch": 1, "image": [64, 64], "output": [64, 64],
       "distinct_inputs": 2, "checked_calls": 2}
STREAMED = {"kind": "streamed", "batch": 1, "image": [32, 32], "features": [8, 8],
            "output": [64, 64], "band_rows": 16, "distinct_inputs": 2, "checked_calls": 1,
            "reference_rows": 24}


def small_vfm(dtype="bfloat16"):
    cfg = json.loads((CONFIGS / "naf-dinov3-vit7b16.json").read_text())
    cfg["backbone"].update(embed_dim=256, depth=2, num_heads=4, mlp_hidden=512)
    cfg["model"].update(NAF_SMALL)
    cfg["values"]["channels"] = 256
    cfg["dtype"] = dtype
    return cfg


def small_streamed(dtype="bfloat16"):
    cfg = json.loads((CONFIGS / "naf-dinov3-s16.json").read_text())
    cfg["model"].update(NAF_SMALL)
    cfg["values"]["channels"] = 8
    cfg["dtype"] = dtype
    return cfg


@pytest.fixture
def small_7b(monkeypatch):
    """The program's 7B at the small configuration's widths."""
    import naf_torch.backbones.wrapper as wrapper

    orig = wrapper.backbone_config
    monkeypatch.setattr(wrapper, "backbone_config",
                        lambda name, *a: orig(name, num_heads=4, embed_dim=256, depth=2))


def _vfm(cfg=None):
    return run.run_cell({"name": VIT_CELL}, cfg or small_vfm(), VFM, SEED, 0.0, False, "cpu")


def _streamed(cfg=None):
    return run.run_cell({"name": STREAMED_CELL}, cfg or small_streamed(), STREAMED, SEED, 0.0,
                        False, "cpu")


def test_vfm_sound_run_passes_and_f32_matches(small_7b):
    res = _vfm()
    assert res["correct"], res["checks"]
    assert set(res["numbers"]) == {"feat_rel_l2", "rel_l2", "max_err"}
    f32 = run.run_cell({"name": VIT_CELL}, small_vfm("float32"), VFM, SEED, 0.0, False, "cpu",
                       limits={})
    assert all(v < 1e-5 for v in f32["numbers"].values()), f32["numbers"]


def test_vfm_control_fails(small_7b):
    nums = calibrate_large.control(small_vfm(), VFM, SEED, torch.device("cpu"))
    assert not check.judge(nums, check.load_limits(VIT_CELL))[0], nums


@pytest.mark.parametrize("fault", sorted(calibrate_large.FAULTS["vfm_upsample"]))
def test_vfm_planted_fault_fails(small_7b, fault):
    plant, number = calibrate_large.FAULTS["vfm_upsample"][fault]
    with plant():
        res = _vfm()
    assert not res["correct"], res["checks"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


def test_vfm_faults_leave_the_program_as_it_was(small_7b):
    before = _vfm()["numbers"]
    for plant, _ in calibrate_large.FAULTS["vfm_upsample"].values():
        with plant():
            pass
    assert _vfm()["numbers"] == before


def test_a_program_without_the_published_shape_fails_before_drawing(monkeypatch):
    import naf_torch.backbones.wrapper as wrapper
    from h100bench.kinds import vfm_upsample

    orig = wrapper.backbone_config
    monkeypatch.setattr(wrapper, "backbone_config", lambda name, *a: orig(
        name, num_heads=4, embed_dim=256, depth=3))
    drawn = []
    monkeypatch.setattr(vfm_upsample, "draw_parts", lambda *a, **k: drawn.append(1))
    with pytest.raises(RuntimeError, match="another shape"):
        _vfm()
    assert not drawn


def test_streamed_sound_run_passes_and_f32_matches():
    res = _streamed()
    assert res["correct"], res["checks"]
    f32 = run.run_cell({"name": STREAMED_CELL}, small_streamed("float32"), STREAMED, SEED, 0.0,
                       False, "cpu", limits={})
    assert all(v < 1e-5 for v in f32["numbers"].values()), f32["numbers"]


def test_streamed_control_and_flipped_rows_fail():
    nums = calibrate_large.control(small_streamed(), STREAMED, SEED, torch.device("cpu"))
    assert not check.judge(nums, check.load_limits(STREAMED_CELL))[0], nums
    plant, number = calibrate_large.FAULTS["streamed"]["rows_flipped"]
    with plant():
        res = _streamed()
    assert not res["correct"] and res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("block_rows", [7, 24, 64])
def test_the_row_blocked_reference_is_the_whole_one(block_rows):
    model = {**json.loads((CONFIGS / "naf-dinov3-s16.json").read_text())["model"], **NAF_SMALL}
    p = ref_naf.naf_params(draw(naf_specs(model), torch.Generator().manual_seed(1),
                                torch.float32))
    gen = torch.Generator().manual_seed(2)
    image, feats = torch.randn(1, 24, 40, 3, generator=gen), torch.randn(1, 6, 5, 8, generator=gen)
    whole = ref_naf.naf_forward(p, model, image, feats, (48, 40))
    got = torch.cat([b for _, b in naf_rows(p, model, image, feats, (48, 40), block_rows)], 1)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


def test_the_vits_work_is_its_flop_count_and_parameters():
    cfg = small_vfm()["backbone"]
    state = draw_parts(dinov3_specs(cfg), torch.Generator().manual_seed(0), torch.float32)
    assert sum(t.numel() for t in state.values()) == work_vit.vit_params(cfg)
    x = torch.randn(1, 48, 64, 3)
    with FlopCounterMode(display=False) as fc:
        dinov3_vit.vit_forward(state, cfg, x)
    assert fc.get_total_flops() == work_vit.vit_work(1, 48, 64, cfg)[0]


def test_draw_parts_is_the_same_draw_whatever_the_parts():
    specs = dinov3_specs(small_vfm()["backbone"])
    a = draw_parts(specs, torch.Generator().manual_seed(3), torch.float32, part=1 << 16)
    b = draw_parts(specs, torch.Generator().manual_seed(3), torch.float32, part=1 << 16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    gammas = torch.cat([v for k, v in a.items() if k.endswith("gamma")])
    assert 0.1 <= float(gammas.min()) and float(gammas.max()) <= 0.5
