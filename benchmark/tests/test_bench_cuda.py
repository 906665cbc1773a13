"""The control on the card, at a size a test run holds: the program with
its bf16 pair math switched on must come out not correct, and the same
run in float32 correct. Decides inside the test whether there is a card."""

import pytest
import torch

import run

SMALL = {"traffic.surfels": 50000, "simulator.sensor.resolution": [256, 256]}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_control_fails_the_check(bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the compositor kernels run only on the card")
    over = {**SMALL, "mapper.raster.bf16_pairs": True} if bf16 else dict(SMALL)
    out = run.run("train-bench-200k", 2**31 + 777, 1.0, False, overrides=over)
    assert out["correct"] is (not bf16), out["checks"]
    assert out["device"]["platform"] == "gpu"
