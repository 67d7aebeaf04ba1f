"""The port's plain VLAD and Fisher-vector encoders against the golden
fixtures that pin the JAX package (``tests/test_golden.py``), at its
tolerance: rtol 1e-5, atol 1e-6. Reading the fixtures needs no JAX, so
``tests/test_torch_cuda.py`` holds the card's kernels 1 and 2 to the same
values."""
import pathlib

import numpy as np
import pytest
import torch

from pyvisim_tpu_torch._config import MODEL_FILES_PATH
from pyvisim_tpu_torch.ops import GmmCodebook, fisher_encode, load_codebook, vlad_encode

DATA = pathlib.Path(__file__).parent / "testdata" / "golden_encodings.npz"


@pytest.fixture(scope="module")
def golden():
    with np.load(DATA) as g:
        return {k: torch.from_numpy(g[k]) for k in g.files}


def _encode(g, case):
    if case == "vlad":
        return vlad_encode(g["desc"], g["mask"], g["centers"])
    if case == "vlad_p05":
        return vlad_encode(g["desc"], g["mask"], g["centers"], power_norm_weight=0.5)
    if case == "fisher":
        gmm = GmmCodebook(weights=g["gmm_w"], means=g["gmm_m"], covariances=g["gmm_c"])
        return fisher_encode(g["desc"], g["mask"], gmm)
    gmm = load_codebook(MODEL_FILES_PATH / "gmm_k256_sift_pca.npz")
    return fisher_encode(g["desc_real"], None, gmm)


@pytest.mark.parametrize("case", ["vlad", "vlad_p05", "fisher", "fisher_real"])
def test_plain_encoders_match_golden_fixtures(golden, case):
    got = _encode(golden, case)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), golden[case].numpy(), rtol=1e-5, atol=1e-6)
