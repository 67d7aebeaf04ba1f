"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points refuse to run on the CPU unless asked to."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "pyvisim_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import pyvisim_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "flax" or m.startswith("flax.")
             or m == "pyvisim_tpu" or m.startswith("pyvisim_tpu."))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax_and_no_jax_package():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert int(count) >= 16
    assert bad == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|pyvisim_tpu)(\.|\s|$)", re.MULTILINE
)


# The card's machine has no JAX: the port, chip_smoke.py and the tests run
# there must not import it.
SCOPES = {
    "package": lambda: sorted(PORT.rglob("*.py")),
    "chip_smoke": lambda: [REPO / "chip_smoke.py"],
    "card_tests": lambda: [REPO / "tests" / "test_torch_cuda.py"],
}


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_sources_import_no_jax_and_no_jax_package(scope):
    files = SCOPES[scope]()
    assert files
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"


def test_forbidden_pattern_spares_the_port_itself():
    assert _FORBIDDEN.search("from pyvisim_tpu.ops import x")
    assert _FORBIDDEN.search("import jax\n")
    assert not _FORBIDDEN.search("from pyvisim_tpu_torch.ops import x")
    assert not _FORBIDDEN.search("import jaxtyping")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_deep_feature_default_device_raises_without_cuda(no_cuda):
    from pyvisim_tpu_torch.features import DeepConvFeature

    with pytest.raises(RuntimeError, match="CUDA"):
        DeepConvFeature(image_size=32)


def test_encoder_and_similarity_default_device_raise_without_cuda(no_cuda):
    from pyvisim_tpu_torch._utils import cosine_similarity
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.ops import KMeansCodebook

    with pytest.raises(RuntimeError, match="CUDA"):
        cosine_similarity(np.ones((1, 4)), np.ones((2, 4)))
    ext = DeepConvFeature(image_size=32, layer_index=0, device="cpu")
    centers = KMeansCodebook(np.zeros((2, ext.output_dim), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        VLADEncoder(ext, kmeans_model=centers, device="cuda")
    # the extractor's device is inherited when the encoder is given none
    assert VLADEncoder(ext, kmeans_model=centers).device.type == "cpu"
