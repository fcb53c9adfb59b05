"""The plain references against the port, in float32 on the CPU at small
sizes: the same weights and inputs, the same outputs, loss, gradients and
update."""

import copy
import json
from pathlib import Path

import pytest
import torch

from h100bench.kinds import distill, upsample
from h100bench.reference.distill import distill_steps, rope_rescale
from h100bench.weights import subseed

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SMALL = {"dim": 32, "heads_attn": 2, "heads_rope": 2, "kernel_size": 3, "img_layers": 1,
         "rope_base": 100.0, "rope_rescale": 2.0, "use_encoder": True}
TEACHER = {"embed_dim": 64, "depth": 1, "num_heads": 2}


def small_upsample(dtype="float32"):
    cfg = json.loads((CONFIGS / "naf-dinov3-s16.json").read_text())
    cfg.update(model=dict(SMALL), dtype=dtype)
    cfg["values"]["channels"] = 8
    return cfg


def small_distill(use_bf16=False):
    cfg = json.loads((CONFIGS / "naf-distill-dinov2-b14.json").read_text())
    cfg.update(model=dict(SMALL), img_size=112)
    cfg["teacher"].update(TEACHER)
    cfg["train"]["use_bf16"] = use_bf16
    return cfg


@pytest.fixture
def small_teacher(monkeypatch):
    """The program's teacher at the small config's widths."""
    import naf_torch.backbones.wrapper as wrapper

    orig = wrapper.backbone_config
    monkeypatch.setattr(wrapper, "backbone_config",
                        lambda name: orig(name, num_heads=2, embed_dim=64, depth=1))


@pytest.mark.parametrize("shapes", [((32, 32), (8, 8), (32, 32)), ((24, 40), (6, 5), (48, 40)),
                                    ((64, 64), (4, 4), (16, 16))])
def test_upsample_reference_matches_the_port(shapes):
    image, feats, out = shapes
    traffic = {"batch": 1, "image": list(image), "features": list(feats), "output": list(out),
               "distinct_inputs": 1, "checked_calls": 1}
    cfg = small_upsample()
    prog = upsample.build(cfg, traffic, 3, torch.device("cpu"))
    got = prog.ups(prog.images[0], prog.feats[0], tuple(out))
    ref = upsample.reference_output(cfg, prog.state, prog.images[0], prog.feats[0], tuple(out))
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_distill_reference_matches_the_port(small_teacher):
    cfg = small_distill(use_bf16=False)
    traffic = {"stack_images": 16, "checked_steps": 3, "chunk_steps": 2}
    prog = distill.Program(cfg, traffic, 5, torch.device("cpu"))
    losses, grad1, params, rows = prog.first_steps(3)
    batches = [prog.stack.index_select(0, torch.as_tensor(r)) for r in rows]
    ref = distill_steps(prog.naf_init, prog.teacher_state, cfg, batches, prog.rope_seed)
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(ref[0]), rtol=1e-5, atol=0)
    nums = distill.numbers(losses, grad1, params, prog.naf_init, ref)
    assert nums["grad_gap"] < 1e-4 and nums["delta_gap"] < 1e-3, nums
    assert len({tuple(sorted(r)) for r in rows}) == 3 and all(len(set(r)) == 4 for r in rows)


def test_rope_draw_is_the_trainers():
    from naf_torch.nn.rope import RoPE
    from naf_torch.train.trainer import step_generator

    rope = RoPE(32, 2, rescale_coords=2.0)
    seed = subseed(2**31 + 7, "rope")
    for step in range(3):
        assert rope.draw(step_generator(seed, step)).rescale == rope_rescale(seed, step, 2.0)


def test_weights_and_inputs_follow_the_seed():
    cfg = small_upsample("bfloat16")
    traffic = {"batch": 1, "image": [16, 16], "features": [4, 4], "output": [16, 16],
               "distinct_inputs": 2, "checked_calls": 2}
    a = upsample.build(cfg, traffic, 2**33 + 1, torch.device("cpu"))
    b = upsample.build(copy.deepcopy(cfg), traffic, 2**33 + 1, torch.device("cpu"))
    c = upsample.build(cfg, traffic, 2**33 + 2, torch.device("cpu"))
    assert all(torch.equal(a.state[k], b.state[k]) for k in a.state)
    assert torch.equal(a.images[1], b.images[1]) and a.checked == b.checked
    assert not torch.equal(a.feats[0], c.feats[0])
