"""``correct`` against the cells' own limits, on the CPU at small sizes:
sound runs pass; the float8 control and each fault the cells can have,
planted under the harness's timed path, fail. The harness's look for a
card is skipped (``run_cell`` on the CPU); everything after it runs."""

import pytest
import torch

from h100bench import calibrate, check, run
from h100bench.tests.test_h100bench_reference import small_distill, small_teacher, small_upsample

UPSAMPLE = {"kind": "upsample", "batch": 1, "image": [32, 32], "features": [8, 8],
            "output": [32, 32], "distinct_inputs": 2, "checked_calls": 2}
DISTILL = {"kind": "distill", "stack_images": 16, "checked_steps": 3, "chunk_steps": 1}
UP_CELLS = ["naf-dinov3-s16.448to2048", "naf-dinov3-s16.448", "naf-dinov3-s16.2048"]
TRAIN_CELL = "naf-distill-dinov2-b14.train"
SEED = 2**31 + 2024
__all__ = ["small_teacher"]  # the fixture, imported for the tests below


def _up(cell):
    return run.run_cell({"name": cell}, small_upsample("bfloat16"), UPSAMPLE, SEED, 0.0, False,
                        "cpu")


def _train():
    return run.run_cell({"name": TRAIN_CELL}, small_distill(use_bf16=True), DISTILL, SEED, 0.0,
                        False, "cpu")


@pytest.mark.parametrize("cell", UP_CELLS)
def test_upsample_sound_and_control(cell):
    res = _up(cell)
    assert res["correct"], res["checks"]
    nums = calibrate._control_upsample(small_upsample("bfloat16"), UPSAMPLE, SEED,
                                       torch.device("cpu"))
    assert not check.judge(nums, check.load_limits(cell))[0], nums


@pytest.mark.parametrize("cell", UP_CELLS)
def test_upsample_answer_altered_where_produced(cell, monkeypatch):
    from naf_torch.api import NAFUpsampler

    served = NAFUpsampler.__call__

    def altered(self, *a, **k):
        out = served(self, *a, **k).clone()
        out[:, :, :2] = -out[:, :, :2]  # two rows of the answer flipped
        return out

    monkeypatch.setattr(NAFUpsampler, "__call__", altered)
    res = _up(cell)
    assert not res["correct"], res["checks"]


def test_train_sound_and_control(small_teacher):
    res = _train()
    assert res["correct"], res["checks"]
    nums = calibrate._control_distill(small_distill(use_bf16=True), DISTILL, SEED,
                                      torch.device("cpu"))
    assert not check.judge(nums, check.load_limits(TRAIN_CELL))[0], nums


def test_train_step_that_leaves_the_state_unchanged(small_teacher, monkeypatch):
    import naf_torch.train.trainer as trainer

    class Frozen(torch.optim.AdamW):
        def step(self, closure=None):
            return None

    monkeypatch.setattr(trainer, "make_optimizer", lambda model, cfg: Frozen(
        model.parameters(), lr=cfg.lr))
    res = _train()
    assert not res["correct"] and res["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


def test_train_half_of_the_batch_left_out(small_teacher, monkeypatch):
    import naf_torch.train.trainer as trainer

    full = trainer.mse_loss
    monkeypatch.setattr(trainer, "mse_loss", lambda p, t, normalize=False: full(
        p[: p.shape[0] // 2], t[: t.shape[0] // 2], normalize))
    res = _train()
    assert not res["correct"], res["checks"]


def test_train_loss_altered_where_produced(small_teacher, monkeypatch):
    import naf_torch.train.trainer as trainer

    full = trainer.mse_loss
    monkeypatch.setattr(trainer, "mse_loss", lambda p, t, normalize=False: 1.01 * full(p, t))
    res = _train()
    assert not res["correct"], res["checks"]
