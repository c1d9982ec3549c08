"""Fixtures of the harness's tests: the repository root on ``sys.path``, a
tiny copy of a cell for CPU runs, and the ``cuda`` fixture, which decides
inside the test whether a card is present."""

import copy
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see portbench/README.md)")
    return torch.device("cuda")


def tiny(cell, dtype="float64", batch=2, check_steps=1):
    """``cell`` at a size the CPU runs in seconds: S3D's graph blocks still
    see 2x2 frames at 64x64, and the queue keeps the loss away from 0."""
    cell = copy.deepcopy(cell)
    cell.settings.update({"DATALOADER.BATCH_SIZE": batch, "INPUT.VIDEO_LENGTH": 8,
                          "INPUT.SCALE_SIZE": [72, 72], "INPUT.BASE_SIZE": [64, 64],
                          "CONTRAST.NCE_K": 256, "TPU.COMPUTE_DTYPE": dtype,
                          "DATASET.NUM_CLASS": 4})
    cell.traffic = {**cell.traffic, "check_steps": check_steps, "pool_batches": 2,
                    "trace_steps": 2}
    return cell


@pytest.fixture
def tiny_cell():
    from portbench.core.cells import resolve

    return tiny(resolve("s3d_gca.moco_112_b256"))
