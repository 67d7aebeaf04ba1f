"""Shared fixtures of the benchmark's own tests: tiny configurations and
mixes that run the whole harness on the CPU in seconds, and the card
fixture of the tests marked ``cuda``."""
from __future__ import annotations

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402


def tiny_vgg() -> dict:
    cfg = copy.deepcopy(run.load_config("vgg16-int8-vlad256"))
    cfg["trunk"]["image_size"] = 96
    # At 96 px the program routes by input side as at 224: int8 where it is
    # 28 to 56 px with >= 64 channels, here convs 2 and 3 (48 px).
    cfg["trunk"]["conv_precision"] = ["bfloat16"] * 2 + ["int8"] * 2 + ["bfloat16"] * 9
    cfg["vlad"]["k"] = 32
    cfg["encoding_dim"] = 32 * 514
    cfg["image"] = {"height": 48, "width": 64}
    cfg["index"]["rows"] = 48
    return cfg


def tiny_sift() -> dict:
    cfg = copy.deepcopy(run.load_config("rootsift-vlad256"))
    cfg["extractor"].update(process_size=64, max_keypoints=64)
    cfg["vlad"]["k"] = 8
    cfg["encoding_dim"] = 8 * 128
    cfg["image"] = {"height": 48, "width": 64}
    cfg["index"]["rows"] = 48
    cfg["vocabulary_images"] = 2
    return cfg


GALLERY = {"kind": "closed", "batch": 3, "pool_batches": 2, "check_rows_per_batch": 2,
           "check_images": 4}
QUERY = {"kind": "open", "rate_per_s": 8, "k": 5, "pool_images": 4,
         "near_copies": [0.95, 0.9, 0.85, 0.8, 0.75], "warmup_queries": 1, "check_queries": 4,
         "arrival_seed": 1}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skip unless a CUDA card is here (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m cuda")
    return torch.device("cuda")
