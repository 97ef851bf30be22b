"""The control on the card: the program with every float32 product in one
TF32 pass, the precision below the configuration's IEEE float32, comes out
not correct at the cell's own size, and the sound program comes out
correct.  Skips without a CUDA device (run it on the card with
``python -m pytest -p no:cacheprovider hmc_bench/tests -m cuda``)."""

import pytest
import torch

from hmc_bench import calibrate, harness


@pytest.mark.cuda
@pytest.mark.parametrize("control,seed", [(False, 3900000001),
                                          (True, 3900000002)])
def test_control_fails_and_the_program_passes(control, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell("dwave16_b8.fast")
    rec = calibrate.one(cell, seed, 5.0, control, torch.device("cuda", 0))
    assert "error" not in rec, rec
    assert rec["tf32"] == [control]
    assert rec["correct"] is (not control), rec["readings"]
