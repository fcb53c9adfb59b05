"""The headline bench (naf_torch.bench.headline) on the card, at a reduced
size with bench.py's widths: each field's launches per call (8 K1 and 1 K2
per forward, one K2 per band of the streamed request, the step's K2
gradient on 1 K3 and 1 K4, the bare call on 1 K3; bf16 on the tensor-core
route), ``vs_baseline`` against the A100's 1000 / 56.24 fps, and a failing
field's command exiting non-zero with no line printed.

Every test carries the marker ``cuda`` and skips without a card. The file
imports no JAX:

    python -m pytest -m cuda tests/test_torch_card_headline.py -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from naf_torch.bench import headline as h

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's widths (dim 256, k 9, 384 feature channels, d 64 / dv 96) at
# half its sides, and 1024^2 in 8 bands of 128 rows for the streamed request
CARD = dict(h.HEADLINE, image=(1, 224, 224, 3), feats=(1, 14, 14, 384),
            image2=(1, 448, 448, 3), feats2=(1, 28, 28, 384), q=(1, 224, 224, 4, 64),
            k=(1, 14, 14, 4, 64), v=(1, 14, 14, 4, 96), img512=(1, 128, 128, 3),
            feats4k=(1, 64, 64, 384), out=224, out2=448, out4k=1024, band_rows=128,
            canary=2048)
QUICK = dict(iters=2, repeats=2, warmup=1)


@pytest.fixture(scope="module")
def record():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 22 runs the headline there")
    return h.run(sizes=CARD, **QUICK)


@pytest.mark.cuda
def test_launches_per_field(record):
    want = h.expected_launches(CARD)
    assert want["fps_4096"]["k2"] == 8
    for name, res in record["fields"].items():
        h.check_launches(name, res["launches"], want[name])
        assert res["ms_min"] <= res["ms"] <= res["ms_max"] and res["peak_mib"] > 0, name


@pytest.mark.cuda
def test_line_and_vs_baseline(record):
    line = h.bench_line(record)
    fps = record["fields"]["naf_fwd_fps_448_r16_dim384"]["value"]
    assert line["vs_baseline"] == round(fps / (1000.0 / 56.24), 2)
    assert line["device"] == torch.cuda.get_device_name(0) and line["dtype"] == "bfloat16"
    assert record["tf32"] is False and record["card"].startswith(line["device"])
    assert all(v > 0 for k, v in line.items() if isinstance(v, float))


@pytest.mark.cuda
def test_stages_on_the_card(record):
    rec = h.stages(sizes=CARD, **QUICK)
    assert list(rec["detail"]) == list(h.STAGE_LAUNCHES)
    for name, res in rec["detail"].items():
        h.check_launches(f"stage {name}", res["launches"], h.STAGE_LAUNCHES[name])
    ms = rec["stages_ms"]
    assert 0 < ms["fused_q"] < ms["model"] and 0 < ms["encoder"] and rec["canary_ms"] > 0


@pytest.mark.cuda
def test_failing_field_exits_non_zero(record):
    code = ("import json, sys\n"
            "from naf_torch.bench import headline as h\n"
            f"h.HEADLINE = json.loads({json.dumps(json.dumps(CARD))})\n"
            "def boom(r): raise RuntimeError('the streamed field failed')\n"
            "h.FIELDS['fps_4096'] = boom\n"
            "sys.exit(h.main([]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    assert r.returncode != 0 and r.stdout == ""
    assert "the streamed field failed" in r.stderr
