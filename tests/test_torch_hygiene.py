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
import importlib, json, pkgutil, sys
import pyvisim_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "pyvisim_tpu"))
print(json.dumps([names, bad]))
"""


def test_importing_every_module_loads_no_jax_and_no_jax_package():
    import json

    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    names, bad = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(names) >= 50
    import pyvisim_tpu_torch

    for sub in pyvisim_tpu_torch.__all__:
        assert f"pyvisim_tpu_torch.{sub}" in names
    for mod in ("io._loader", "io._prefetch", "datasets.synthetic", "losses._losses",
                "models.resnet", "models.siamese", "encoders.siamese", "ops.spectral",
                "datasets.datasets", "_utils", "parallel.mesh", "parallel.distributed",
                "parallel.sharded", "parallel.train"):
        assert f"pyvisim_tpu_torch.{mod}" in names
    assert bad == []


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|orbax|pyvisim_tpu)(\.|\s|$)", re.MULTILINE
)


# The card's machine has no JAX: the port, chip_smoke.py, the probes and
# the tests run there must not import it.
SCOPES = {
    "package": lambda: sorted(PORT.rglob("*.py")),
    "chip_smoke": lambda: [REPO / "chip_smoke.py"],
    "conv_probe": lambda: [REPO / "conv_probe.py"],
    "kernel_probe": lambda: [REPO / "kernel_probe.py"],
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
    assert _FORBIDDEN.search("import optax\n") and _FORBIDDEN.search("from orbax import checkpoint")


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


def test_fisher_encoder_and_pipeline_default_device_raise_without_cuda(no_cuda):
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder, Pipeline, VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.ops import GmmCodebook, KMeansCodebook

    ext = DeepConvFeature(image_size=32, layer_index=0, device="cpu")
    d = ext.output_dim
    gmm = GmmCodebook(weights=np.ones(2, np.float32) / 2, means=np.zeros((2, d), np.float32),
                      covariances=np.ones((2, d), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        FisherVectorEncoder(ext, gmm_model=gmm, device="cuda")
    # no extractor: the default RootSIFT runs on the default device too
    with pytest.raises(RuntimeError, match="CUDA"):
        FisherVectorEncoder(gmm_model=gmm)
    fv = FisherVectorEncoder(ext, gmm_model=gmm)
    vlad = VLADEncoder(ext, kmeans_model=KMeansCodebook(np.zeros((2, d), np.float32)))
    assert fv.device.type == "cpu"
    # the Pipeline's default similarity runs on its first encoder's device
    sims = Pipeline([fv, vlad]).similarity_func(np.ones((1, 4)), np.ones((2, 4)))
    assert sims.shape == (1, 2)


@pytest.mark.parametrize("fit", ["kmeans_fit", "gmm_fit", "pca_fit"])
def test_fits_default_device_raises_without_cuda(no_cuda, fit):
    from pyvisim_tpu_torch import ops

    x = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(ops, fit)(x, 2)
    assert getattr(ops, fit)(x, 2, device="cpu") is not None


def test_sift_default_device_raises_without_cuda(no_cuda):
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import SIFT, RootSIFT
    from pyvisim_tpu_torch.ops import sift

    for make in (SIFT, RootSIFT, VLADEncoder,
                 lambda: sift.sift_batch([np.zeros((8, 8), np.uint8)], max_keypoints=16)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert RootSIFT(device="cpu").device.type == "cpu"
    assert VLADEncoder(device="cpu").feature_extractor.device.type == "cpu"


def test_index_and_prefetch_default_device_raise_without_cuda(no_cuda, tmp_path):
    from pyvisim_tpu_torch.features import SIFT
    from pyvisim_tpu_torch.index import RetrievalIndex
    from pyvisim_tpu_torch.io import PrefetchIterator, prefetch_to_device

    vecs = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    paths = [str(i) for i in range(4)]
    for make in (lambda: RetrievalIndex(vecs, paths),
                 lambda: RetrievalIndex.from_encoding_map(dict(zip(paths, vecs))),
                 lambda: prefetch_to_device(iter([vecs])),
                 lambda: SIFT(backend="opencv")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    cpu = RetrievalIndex(vecs, paths, quantize="int8", device="cpu")
    cpu.save(str(tmp_path / "i.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalIndex.load(str(tmp_path / "i.npz"))
    assert RetrievalIndex.load(str(tmp_path / "i.npz"), device="cpu").device.type == "cpu"
    # a host-only prefetch needs no device
    assert next(PrefetchIterator(iter([vecs]), to_device=False)) is vecs


def test_conv_probe_patches_lines_that_the_conv_source_has():
    """conv_probe.py builds conv.cu with parts removed by replacing literal
    lines; each must still be in the source (the probe raises otherwise,
    and only on the card)."""
    sys.path.insert(0, str(REPO))
    try:
        import conv_probe
    finally:
        sys.path.remove(str(REPO))
    source = (PORT / "csrc" / "conv.cu").read_text()
    assert set(conv_probe.VARIANTS) == {"as built", "no mma", "no staging", "no stores",
                                        "16x16 tiles", "32x8 tiles", "4 stages"}
    for name, edits in conv_probe.VARIANTS.items():
        for old, _ in edits:
            assert old in source, f"{name}: {old!r}"


@pytest.mark.parametrize("source, table", [("sift_window", "SIFT_VARIANTS"),
                                           ("gmm_stats", "GMM_VARIANTS"),
                                           ("aggregate", "AGG_VARIANTS")])
def test_kernel_probe_patches_lines_that_the_sources_have(source, table):
    """kernel_probe.py builds sift_window.cu, gmm_stats.cu and aggregate.cu
    with parts removed by replacing literal lines; each must still be in its
    source (the probe raises otherwise, and only on the card)."""
    sys.path.insert(0, str(REPO))
    try:
        import kernel_probe
    finally:
        sys.path.remove(str(REPO))
    text = (PORT / "csrc" / f"{source}.cu").read_text()
    variants = getattr(kernel_probe, table)
    assert "as built" in variants and len(variants) >= 3
    for name, edits in variants.items():
        for old, _ in edits:
            assert old in text, f"{name}: {old!r}"


def test_trainer_encoder_and_resnet_default_device_raise_without_cuda(no_cuda):
    from pyvisim_tpu_torch.encoders import SiameseEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.models.resnet import ResNetTrunk
    from pyvisim_tpu_torch.models.siamese import SiameseEmbedder, adamw, create_train_state

    model = SiameseEmbedder("vgg11", embed_dim=8, trunk_convs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(model, adamw(1e-3))
    state = create_train_state(model, adamw(1e-3), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SiameseEncoder.from_train_state(model, state)
    assert SiameseEncoder.from_train_state(model, state, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        DeepConvFeature(module=ResNetTrunk("resnet18", n_stages=1), image_size=32)


def test_clustering_blur_and_dice_default_device_raise_without_cuda(no_cuda):
    from pyvisim_tpu_torch import _utils
    from pyvisim_tpu_torch.ops import spectral_cluster

    x = np.random.default_rng(0).normal(size=(30, 4)).astype(np.float32)
    img = np.zeros((16, 16, 3), np.uint8)
    for make in (lambda: spectral_cluster(x, 2),
                 lambda: _utils.cluster_and_return_labels(x, "kmeans", 2),
                 lambda: _utils.cluster_and_return_labels(x, "spectral", 2),
                 lambda: _utils.cluster_images_and_generate_statistics(x, np.zeros(30), 2),
                 lambda: _utils.gaussian_blur(img),
                 lambda: _utils.soft_dice_score(x, x)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert spectral_cluster(x, 2, device="cpu").shape == (30,)
    assert _utils.gaussian_blur(img, device="cpu").shape == img.shape


def test_parallel_exports_the_jax_packages_names():
    """``pyvisim_tpu_torch.parallel`` exports the 19 names of JAX's
    ``parallel/__init__.py`` (read from its source, not imported)."""
    import ast

    import pyvisim_tpu_torch.parallel as par

    tree = ast.parse((REPO / "pyvisim_tpu" / "parallel" / "__init__.py").read_text())
    jax_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign) and node.targets[0].id == "__all__")
    assert len(jax_all) == 19
    assert list(par.__all__) == jax_all
    assert all(callable(getattr(par, name)) for name in jax_all)


_MODULE_LEVEL_IMPORT = re.compile(r"^(import|from)\s+(jax|flax|optax|orbax|pyvisim_tpu)(\.|\s|$)",
                                  re.MULTILINE)


@pytest.mark.parametrize("name", ["test_torch_parallel", "test_torch_parallel_train",
                                  "test_torch_parallel_mesh", "test_torch_cuda"])
def test_files_that_ranks_import_load_no_jax_at_import(name):
    """Rank processes import these files for their jobs: JAX only inside
    their fixtures, never at module level."""
    text = (REPO / "tests" / f"{name}.py").read_text()
    assert not _MODULE_LEVEL_IMPORT.findall(text)


def test_mesh_entry_points_raise_without_cuda(no_cuda, monkeypatch):
    from pyvisim_tpu_torch.parallel import init_distributed, make_mesh
    from pyvisim_tpu_torch.parallel.local import LocalWorld

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalWorld(2, "gloo", "cuda")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed("localhost:1", 2, 0)
