"""The SIFT/RootSIFT slice end to end in both stacks: ``sift_descriptors``
on the same letterboxed uint8 images, the encoders' default extractor,
the shipped RootSIFT VLAD-k256 and GMM-k256/PCA-64 Fisher vectors, and the
Pipeline's shared extraction.

The port's pyramid sums its blurs in another order than JAX's banded
matmuls (1e-4 at 0..255 scale), and detection compares bf16-rounded DoG
values, so a DoG value near a bf16 rounding boundary can move one extremum
in or out; end to end the gates are therefore statistical: valid counts
within 2 %, >= 97 % of JAX's keypoints found at the same (octave, layer,
row, col) and angle, and their descriptors within 1 unit on >= 99 % of
entries. Stage by stage parity is in ``tests/test_torch_sift.py``.
"""
import matplotlib.cbook as cbook
import numpy as np
import pytest
import torch
from PIL import Image

from pyvisim_tpu.encoders import FisherVectorEncoder as JFisherVectorEncoder
from pyvisim_tpu.encoders import GMMWeights as JGMMWeights
from pyvisim_tpu.encoders import KMeansWeights as JKMeansWeights
from pyvisim_tpu.encoders import VLADEncoder as JVLADEncoder
from pyvisim_tpu.features import RootSIFT as JRootSIFT
from pyvisim_tpu.ops import sift as J
from pyvisim_tpu_torch.encoders import (FisherVectorEncoder, GMMWeights, KMeansWeights,
                                        Pipeline, VLADEncoder)
from pyvisim_tpu_torch.features import SIFT, Lambda, RootSIFT
from pyvisim_tpu_torch.features._features import _to_gray_u8
from pyvisim_tpu_torch.ops import sift as T

PS, MAX_KP = 128, 192
# The extractors' own configuration, so the JAX encoders reuse the
# fixture's compiled program.
JCFG = J.SiftConfig(process_size=PS, max_keypoints=MAX_KP)
TCFG = T.SiftConfig(process_size=PS, max_keypoints=MAX_KP)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here is small: one intra-op thread keeps it from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images():
    """A photograph (matplotlib's grace_hopper.jpg, as tests/test_sift.py
    uses) and a synthetic image of colour blocks, both RGB uint8."""
    with cbook.get_sample_data("grace_hopper.jpg") as f:
        photo = np.asarray(Image.open(f).convert("RGB"))
    rng = np.random.default_rng(0)
    grid = rng.integers(0, 256, size=(6, 8, 3))
    blocks = np.repeat(np.repeat(grid, 20, axis=0), 20, axis=1)
    blocks = np.clip(blocks + rng.normal(0, 8, blocks.shape), 0, 255).astype(np.uint8)
    return [photo, blocks]


@pytest.fixture(scope="module")
def images():
    return _images()


@pytest.fixture(scope="module")
def both(images):
    grays = [_to_gray_u8(im) for im in images]
    want = {k: np.asarray(v) for k, v in J.sift_descriptors(grays, JCFG).items()}
    got = T.sift_descriptors(grays, TCFG, run_on="cpu")
    return got, want


def _keys(out, i):
    """(octave, layer, row, col) of image i's valid keypoints, decoded from
    the outputs in process coordinates (x = (c + xc) 2^o / 2, size = 1.6
    2^((layer + xi)/3) 2^o, |xc|, |xr|, |xi| < 0.5), and their angles."""
    m = out["mask"][i] > 0
    v = np.log2(out["size"][i][m] / 1.6)
    frac = v - np.floor(v)
    octave = np.floor(v).astype(int) - (frac < 1 / 6)
    layer = np.rint(3 * (v - octave)).astype(int)
    unit = 2.0 ** octave / 2.0
    row = np.rint(out["y"][i][m] / unit).astype(int)
    col = np.rint(out["x"][i][m] / unit).astype(int)
    return list(zip(octave, layer, row, col)), out["theta"][i][m], out["desc"][i][m]


def test_sift_descriptors_match_jax(both):
    got, want = both
    assert set(got) == set(want) == {"desc", "mask", "x", "y", "size", "theta", "response"}
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
    for i in range(2):
        n_got, n_want = int(got["mask"][i].sum()), int(want["mask"][i].sum())
        assert n_want > 50
        assert abs(n_got - n_want) <= 0.02 * n_want
        kg, tg, dg = _keys(got, i)
        kw, tw, dw = _keys(want, i)
        index = {}
        for j, key in enumerate(kg):
            index.setdefault(key, []).append(j)
        pairs = []
        for j, key in enumerate(kw):
            hits = [g for g in index.get(key, []) if abs(tg[g] - tw[j]) < 1e-3]
            if hits:
                pairs.append((hits[0], j))
        assert len(pairs) >= 0.97 * n_want
        diff = np.abs(dg[[g for g, _ in pairs]] - dw[[j for _, j in pairs]])
        assert (diff <= 1.0).mean() >= 0.99


def test_sift_batch_and_root_sift(both, images):
    got, _ = both
    grays = [_to_gray_u8(im) for im in images]
    desc, mask = T.sift_batch(grays, max_keypoints=MAX_KP, cfg=TCFG, run_on="cpu")
    np.testing.assert_array_equal(desc, got["desc"])
    np.testing.assert_array_equal(mask, got["mask"])
    root, root_mask = T.sift_batch(grays, max_keypoints=MAX_KP, root_sift=True, cfg=TCFG,
                                   device=True, run_on="cpu")
    assert torch.is_tensor(root) and root.device.type == "cpu"
    d = got["desc"]
    want = np.sqrt(d / (d.sum(axis=-1, keepdims=True) + 1e-7)) * got["mask"][..., None]
    np.testing.assert_allclose(root.numpy(), want, rtol=1e-6, atol=1e-6)
    norms = np.linalg.norm(root.numpy()[root_mask.numpy() > 0], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_device_results_are_capped(monkeypatch):
    monkeypatch.setenv("PYVISIM_SIFT_DEVICE_BATCH", "1")
    tiny = [np.zeros((8, 8), np.uint8)] * 17
    with pytest.raises(ValueError, match="device=True"):
        T.sift_batch(tiny, max_keypoints=16, device=True, run_on="cpu")


def test_encoders_default_to_root_sift_as_jax():
    for port, jax_enc in ((VLADEncoder(device="cpu"), JVLADEncoder()),
                          (FisherVectorEncoder(device="cpu"), JFisherVectorEncoder())):
        t_ext, j_ext = port.feature_extractor, jax_enc.feature_extractor
        assert isinstance(t_ext, RootSIFT) and isinstance(j_ext, JRootSIFT)
        for attr in ("max_keypoints", "process_size", "output_dim", "descriptor_budget"):
            assert getattr(t_ext, attr) == getattr(j_ext, attr)
        assert t_ext.backend == "torch" and t_ext.device.type == "cpu"
    shared = {f.name for f in T.SiftConfig.__dataclass_fields__.values()}
    assert shared < set(J.SiftConfig.__dataclass_fields__)
    assert {n: getattr(T.SiftConfig(), n) for n in shared} == \
        {n: getattr(J.SiftConfig(), n) for n in shared}


@pytest.fixture(scope="module")
def encoders():
    t_ext = RootSIFT(max_keypoints=MAX_KP, process_size=PS, device="cpu")
    j_ext = JRootSIFT(max_keypoints=MAX_KP, process_size=PS)
    return (
        (VLADEncoder(t_ext, weights=KMeansWeights.OXFORD102_K256_ROOTSIFT),
         JVLADEncoder(j_ext, weights=JKMeansWeights.OXFORD102_K256_ROOTSIFT)),
        (FisherVectorEncoder(t_ext, weights=GMMWeights.OXFORD102_K256_ROOTSIFT_PCA),
         JFisherVectorEncoder(j_ext, weights=JGMMWeights.OXFORD102_K256_ROOTSIFT_PCA)),
    )


def _cosine(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_shipped_root_sift_encodings_match_jax(encoders, images):
    """VLAD-k256 (32,768-D) and FV-k256 on PCA 128 -> 64 (33,024-D) with the
    shipped RootSIFT vocabularies, at cosine >= 0.99 per image."""
    dims = (256 * 128, 2 * 256 * 64 + 256)
    for (port, jax_enc), dim in zip(encoders, dims):
        got, want = port.encode(images), np.asarray(jax_enc.encode(images))
        assert got.shape == want.shape == (2, dim)
        assert (_cosine(got, want) >= 0.99).all()


def test_pipeline_shares_one_extraction(encoders, images, monkeypatch):
    (vlad, _), (fv, _) = encoders
    ext = vlad.feature_extractor
    assert fv.feature_extractor is ext
    calls = []
    inner = ext.extract_batch_device
    monkeypatch.setattr(ext, "extract_batch_device",
                        lambda imgs: calls.append(1) or inner(imgs))
    out = Pipeline([vlad, fv]).encode(images)
    assert len(calls) == 1
    np.testing.assert_allclose(out, np.hstack([vlad.encode(images), fv.encode(images)]),
                               atol=1e-6)


def test_extractor_call_and_lambda(images):
    """One image through ``__call__`` (the float path) gives the valid rows
    of the batched uint8 path when no resize is needed; ``Lambda`` wraps a
    callable and checks its output width."""
    img = images[1][:PS, :PS]
    for cls in (SIFT, RootSIFT):
        ext = cls(max_keypoints=MAX_KP, process_size=PS, device="cpu")
        desc, mask = ext.extract_batch([img])
        np.testing.assert_allclose(ext(img), desc[0][mask[0] > 0], atol=1e-6)
    lam = Lambda(lambda im: np.ones((3, 5), np.float32), output_dim=5)
    assert lam(img).shape == (3, 5)
    with pytest.raises(ValueError):
        Lambda(lambda im: np.ones((3, 4), np.float32), output_dim=5)(img)
    with pytest.raises(ValueError, match="backend"):
        SIFT(backend="tpu", device="cpu")  # the port's batched backend is "torch"
    assert SIFT(backend="opencv", device="cpu").descriptor_budget is None
