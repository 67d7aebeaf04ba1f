"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch; the suite's conftest.py sets up JAX, so leave it out there:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

import numpy as np

from pyvisim_tpu_torch import index as tindex
from pyvisim_tpu_torch import io as tio
from pyvisim_tpu_torch import profiling
from pyvisim_tpu_torch.io import _staging as tstaging
from pyvisim_tpu_torch.models import QuantConv
from pyvisim_tpu_torch.models import quant as tquant
from pyvisim_tpu_torch.models import vgg as tvgg
from pyvisim_tpu_torch.models import vit as tvit
from pyvisim_tpu_torch.ops import fisher as tfisher
from pyvisim_tpu_torch.ops import gmm as tgmm
from pyvisim_tpu_torch.ops import kmeans as tkmeans
from pyvisim_tpu_torch.ops import sift as tsift
from pyvisim_tpu_torch.ops import vlad as tvlad
from pyvisim_tpu_torch.ops.codebooks import GmmCodebook, KMeansCodebook
from pyvisim_tpu_torch.ops.cuda import aggregate as tagg
from pyvisim_tpu_torch.ops.cuda import conv as tconv
from pyvisim_tpu_torch.ops.cuda import gmm_stats as tgs
from pyvisim_tpu_torch.ops.cuda import ingest as tingest
from pyvisim_tpu_torch.ops.cuda import int8_epilogue as tepi
from pyvisim_tpu_torch.ops.cuda import lloyd_stats as tls
from pyvisim_tpu_torch.ops.cuda import sift_window as tsw
from pyvisim_tpu_torch.ops.cuda import vit_passes as tvp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _margin_batch(b, n, d, k, seed=0):
    """Descriptors near known centers, so the nearest center is never a
    near tie and labels must agree exactly; some zero and one fractional
    weight."""
    g = torch.Generator().manual_seed(seed)
    protos = torch.randn(k, d, generator=g)
    labels = torch.randint(0, k, (b, n), generator=g)
    desc = protos[labels] + 0.1 * torch.randn(b, n, d, generator=g)
    mask = (torch.rand(b, n, generator=g) > 0.1).float()
    if n:
        mask[0, 0] = 0.37
    centers = protos + 0.01 * torch.randn(k, d, generator=g)
    return desc, mask, centers


def _labels_agree(labels, ref_labels, mask):
    """Rows of nonzero weight carry the plain argmin's label; a row of zero
    weight carries it too or -1, the kernel's label of a row it need not
    assign."""
    weighted = mask != 0
    assert torch.equal(labels[weighted], ref_labels[weighted])
    rest = labels[~weighted]
    assert bool(((rest == ref_labels[~weighted]) | (rest == -1)).all())


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


# (B, N, D, K): the main path's widths; ragged row, depth, column and
# center tiles; and K = 600 and 1000.
SHAPES = [
    (4, 196, 514, 16), (3, 2048, 128, 256), (3, 17, 33, 5), (2, 300, 130, 70), (1, 50, 514, 300),
    (1, 40, 130, 600), (1, 30, 70, 1000),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vlad_kernel_matches_plain_version(cuda_device, shape):
    desc, mask, centers = (t.to(cuda_device) for t in _margin_batch(*shape))
    before = tagg.vlad_aggregate_batched.launches
    out, labels = tagg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    ref, ref_labels = tagg.vlad_aggregate_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    assert tagg.vlad_aggregate_batched.launches == before + 1
    _labels_agree(labels, ref_labels, mask)
    # f32 sums in another order than the plain bmm's.
    tol = 1e-4 * ref.abs().max().item() + 1e-5
    assert (out - ref).abs().max().item() <= tol


def test_vlad_kernel_masked_and_empty_sets(cuda_device):
    desc, mask, centers = (t.to(cuda_device) for t in _margin_batch(2, 40, 64, 8))
    mask[1] = 0.0
    out = tagg.vlad_aggregate_batched(desc, mask, centers)
    torch.cuda.synchronize()
    assert not out[1].any()
    empty = tagg.vlad_aggregate_batched(desc[:, :0].contiguous(), mask[:, :0].contiguous(), centers)
    assert tuple(empty.shape) == (2, 8, 64) and not empty.any()


def test_vlad_kernel_refuses_what_it_does_not_take(cuda_device):
    desc, mask, centers = (t.to(cuda_device) for t in _margin_batch(2, 8, 16, 3))
    with pytest.raises(TypeError):
        tagg.vlad_aggregate_batched(desc.half(), mask, centers)
    with pytest.raises(ValueError):
        tagg.vlad_aggregate_batched(desc, mask, centers.cpu())
    with pytest.raises(ValueError):
        tagg.vlad_aggregate_batched(desc.transpose(0, 1), mask, centers)


@pytest.mark.parametrize("chunk_size", [None, 64])
def test_vlad_encode_batch_on_card_matches_cpu(cuda_device, chunk_size):
    desc, mask, centers = _margin_batch(3, 196, 514, 32, seed=1)
    kw = dict(power_norm_weight=0.5, chunk_size=chunk_size)
    want = tvlad.vlad_encode_batch(desc, mask, centers, **kw)
    on_card = (t.to(cuda_device) for t in (desc, mask, centers))
    got = tvlad.vlad_encode_batch(*on_card, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def _gmm_batch(b, n, d, k, seed=0):
    """Descriptors drawn from a random diagonal GMM, so posteriors are not
    all one-hot; some zero weights, one fractional, and with b > 1 one
    fully masked set."""
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(k, generator=g) + 0.1
    means = 2.0 * torch.randn(k, d, generator=g)
    covs = torch.rand(k, d, generator=g) + 0.5
    comp = torch.randint(0, k, (b, n), generator=g)
    desc = means[comp] + covs[comp].sqrt() * torch.randn(b, n, d, generator=g)
    mask = (torch.rand(b, n, generator=g) > 0.1).float()
    if n:
        mask[0, 0] = 0.37
    if b > 1:
        mask[1] = 0.0
    return desc, mask, w / w.sum(), means, covs


def _close(got, want, what):
    tol = 1e-4 * want.abs().max().item() + 1e-5
    err = (got - want).abs().max().item()
    assert err <= tol, f"{what}: max|diff| {err} > {tol}"


# (B, N, D, K): the encode and EM widths, the RootSIFT FV width (sets of
# 2,048 rows, two row segments each), ragged row/column/component tiles,
# one set cut into several row segments, K = 1 and one row.
GMM_SHAPES = [
    (2, 196, 257, 256), (3, 2048, 64, 256), (3, 17, 33, 7), (1, 3000, 257, 1), (1, 2500, 514, 7),
    (4, 1, 20, 5), (2, 2100, 40, 70),
]


@pytest.mark.parametrize("shape", GMM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gmm_stats_kernel_matches_plain_version(cuda_device, shape):
    args = [t.to(cuda_device) for t in _gmm_batch(*shape)]
    before = tgs.gmm_stats_batched.launches
    got = tgs.gmm_stats_batched(*args, with_ll=True)
    want = tgs.gmm_stats_reference(*args, with_ll=True)
    torch.cuda.synchronize()
    assert tgs.gmm_stats_batched.launches == before + 1
    for name, a, b in zip(("s0", "s1", "s2"), got, want):
        _close(a, b, name)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-3)
    if shape[0] > 1:
        assert not any(t[1].any() for t in got)
    again = tgs.gmm_stats_batched(*args, with_ll=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gmm_stats_kernel_empty_sets_and_refusals(cuda_device):
    desc, mask, w, mu, cov = (t.to(cuda_device) for t in _gmm_batch(2, 0, 16, 3))
    before = tgs.gmm_stats_batched.launches
    s0, s1, s2 = tgs.gmm_stats_batched(desc, mask, w, mu, cov)
    assert tgs.gmm_stats_batched.launches == before
    assert tuple(s1.shape) == (2, 3, 16) and not (s0.any() or s1.any() or s2.any())
    desc, mask, w, mu, cov = (t.to(cuda_device) for t in _gmm_batch(2, 8, 16, 3))
    with pytest.raises(TypeError):
        tgs.gmm_stats_batched(desc.half(), mask, w, mu, cov)
    with pytest.raises(ValueError):
        tgs.gmm_stats_batched(desc, mask, w, mu.cpu(), cov)
    with pytest.raises(ValueError):
        tgs.gmm_stats_batched(desc, mask, w, mu[:, :8].contiguous(), cov)


def _rootsift_like(b, n, d, k, n_valid, seed=0):
    """Sets whose first ``n_valid`` rows carry weight and the rest are
    masked, as a RootSIFT encode sends them (rows sorted valid first)."""
    desc, mask, w, mu, cov = _gmm_batch(b, n, d, k, seed=seed)
    mask = torch.zeros_like(mask)
    mask[:, :n_valid] = 1.0
    mask[0, 5] = 0.37
    return desc, mask, w, mu, cov


# (B, N, D, K, valid rows a set): the RootSIFT FV encode's shape with
# about 361 valid rows a set, and a K above the fused-softmax limit, on the
# encode and on the EM form.
MASKED_SHAPES = [
    (64, 2048, 64, 256, 361), (4, 700, 24, 300, 150), (1, 3000, 40, 300, 1000),
    (3, 500, 257, 256, 70),
]


@pytest.mark.parametrize("shape", MASKED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gmm_stats_kernel_on_mostly_masked_sets(cuda_device, shape):
    args = [t.to(cuda_device) for t in _rootsift_like(*shape)]
    before = tgs.gmm_stats_batched.launches
    got = tgs.gmm_stats_batched(*args, with_ll=True)
    want = tgs.gmm_stats_reference(*args, with_ll=True)
    torch.cuda.synchronize()
    assert tgs.gmm_stats_batched.launches == before + 1
    for name, a, b in zip(("s0", "s1", "s2"), got, want):
        _close(a, b, name)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-3)
    again = tgs.gmm_stats_batched(*args, with_ll=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("k", [256, 300])
@pytest.mark.parametrize("poison", ["nan", "inf", "overflow"])
def test_gmm_stats_kernel_carries_a_masked_rows_nan(cuda_device, k, poison):
    """A NaN, an inf, or a finite value whose square overflows logp, in a
    masked row among masked rows: NaN on that set's statistics exactly
    where the plain version has it, the other sets unchanged; a set of
    masked finite rows gives zeros."""
    desc, mask, w, mu, cov = (t.to(cuda_device) for t in _rootsift_like(3, 600, 32, k, 100))
    cov = 0.01 * cov  # so that 5e18 squared, finite, overflows logp on every component
    clean = tgs.gmm_stats_batched(desc, mask, w, mu, cov, with_ll=True)
    value = {"nan": float("nan"), "inf": float("inf"), "overflow": 5e18}[poison]
    desc[0, 400, 7] = value
    mask[2] = 0.0
    got = tgs.gmm_stats_batched(desc, mask, w, mu, cov, with_ll=True)
    want = tgs.gmm_stats_reference(desc, mask, w, mu, cov, with_ll=True)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, clean):
        assert torch.equal(a.isnan(), b.isnan())
        assert a[0].isnan().all()
        assert torch.equal(a[1], c[1])
        assert not a[2].any()


# (N, D, K): the training widths, ragged tiles, several row segments,
# K = 1, one row, and enough centers for 64- and 32-column slices.
LLOYD_SHAPES = [
    (3000, 514, 256), (777, 257, 7), (50, 33, 1), (1, 16, 5), (2100, 130, 600),
    (1500, 70, 1000),
]


@pytest.mark.parametrize("shape", LLOYD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lloyd_kernel_matches_plain_version(cuda_device, shape):
    n, d, k = shape
    desc, mask, centers = _margin_batch(1, n, d, k)
    desc, mask, centers = (t.to(cuda_device) for t in (desc[0], mask[0], centers))
    before = tls.lloyd_stats.launches
    got = tls.lloyd_stats(desc, mask, centers, return_labels=True)
    want = tls.lloyd_stats_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    assert tls.lloyd_stats.launches == before + 1
    _labels_agree(got[3], want[3], mask)
    _close(got[0], want[0], "sums")
    _close(got[1], want[1], "counts")
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-4)
    again = tls.lloyd_stats(desc, mask, centers, return_labels=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_lloyd_kernel_empty_set(cuda_device):
    desc, mask, centers = (t.to(cuda_device) for t in _margin_batch(1, 0, 16, 3))
    sums, counts, inertia = tls.lloyd_stats(desc[0], mask[0], centers)
    assert tuple(sums.shape) == (3, 16)
    assert not (sums.any() or counts.any() or inertia.item())


# Kernels 1 and 3 on non-finite inputs. (B, N, D, K, valid rows a set):
# the deep VLAD shape with a tenth of the rows weightless at random, and
# RootSIFT-like sets whose weight is a prefix (the rest in weightless
# row tiles). Lloyd takes the same rows as one set.
NONFINITE_SHAPES = {"deep": (128, 196, 514, 256, None), "prefix": (4, 2048, 128, 256, 361)}
NONFINITE_CASES = ("nan_weighted", "nan_weightless", "inf_weightless", "inf_weighted")


def _poisoned(shape, case):
    b, n, d, k, n_valid = shape
    desc, mask, centers = _margin_batch(b, n, d, k, seed=3)
    if n_valid is not None:
        mask = torch.zeros_like(mask)
        mask[:, :n_valid] = 1.0
        mask[0, 5] = 0.37
    weighted = case.endswith("_weighted")
    rows = ((mask[1] != 0) == weighted).nonzero()[:, 0]
    row = int(rows[len(rows) // 2])  # with a prefix, a weightless row tile's
    desc[1, row, 7] = float("inf") if case.startswith("inf") else float("nan")
    return desc, mask, centers


def _nonfinite_agree(got, want):
    """NaN and +-inf exactly where the plain version has them, the finite
    entries within the tolerance of the clean tests."""
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    finite = want.isfinite()
    if finite.any():
        _close(got[finite], want[finite], "finite entries")


@pytest.mark.parametrize("case", NONFINITE_CASES)
@pytest.mark.parametrize("shape", sorted(NONFINITE_SHAPES))
def test_vlad_kernel_carries_nan_and_inf_as_the_plain_version(cuda_device, shape, case):
    desc, mask, centers = (t.to(cuda_device) for t in _poisoned(NONFINITE_SHAPES[shape], case))
    out, labels = tagg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    again = tagg.vlad_aggregate_batched(desc, mask, centers)
    ref, ref_labels = tagg.vlad_aggregate_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    # The plain bmm's 0 * NaN and 0 * inf: column 7 of set 1 is NaN in
    # every cluster, but for an inf in a weighted row, which leaves +-inf
    # in its own cluster.
    assert int(ref[1, :, 7].isnan().sum()) == ref.shape[1] - (case == "inf_weighted")
    _nonfinite_agree(out, ref)
    _labels_agree(labels, ref_labels, mask)
    assert _same_bits(out, again)


@pytest.mark.parametrize("case", NONFINITE_CASES)
@pytest.mark.parametrize("shape", sorted(NONFINITE_SHAPES))
def test_lloyd_kernel_carries_nan_and_inf_as_the_plain_version(cuda_device, shape, case):
    desc, mask, centers = _poisoned(NONFINITE_SHAPES[shape], case)
    d = desc.shape[-1]
    desc, mask, centers = (t.to(cuda_device) for t in (desc.reshape(-1, d), mask.reshape(-1),
                                                        centers))
    got = tls.lloyd_stats(desc, mask, centers, return_labels=True)
    again = tls.lloyd_stats(desc, mask, centers, return_labels=True)
    want = tls.lloyd_stats_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    assert int(want[0][:, 7].isnan().sum()) == want[0].shape[0] - (case == "inf_weighted")
    _nonfinite_agree(got[0], want[0])
    _close(got[1], want[1], "counts")
    assert bool(got[2].isnan()) == bool(want[2].isnan())
    _labels_agree(got[3], want[3], mask)
    assert all(_same_bits(a, b) for a, b in zip(got, again))


# Valid prefixes of 0, 1, 63, 64, 65, 361 and 2,048 rows in sets of 2,048
# rows: at and around the row tiles' edges, the RootSIFT encode's typical
# count, a full set and a fully weightless one.
PREFIXES = (0, 1, 63, 64, 65, 361, 2048)


def _prefix_sets():
    desc, _, centers = _margin_batch(len(PREFIXES), 2048, 128, 256, seed=4)
    mask = torch.zeros(desc.shape[:2])
    for b, n_valid in enumerate(PREFIXES):
        mask[b, :n_valid] = 1.0
    mask[6, 100] = 0.37
    return desc, mask, centers


def test_vlad_kernel_on_valid_prefixes(cuda_device):
    desc, mask, centers = (t.to(cuda_device) for t in _prefix_sets())
    out, labels = tagg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    again = tagg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    ref, ref_labels = tagg.vlad_aggregate_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    _labels_agree(labels, ref_labels, mask)
    assert bool((labels[0] == -1).all())
    assert not out[0].any()
    _close(out, ref, "sums")
    assert _same_bits(out, again[0]) and torch.equal(labels, again[1])


def test_lloyd_kernel_on_valid_prefixes(cuda_device):
    desc, mask, centers = _prefix_sets()
    desc, mask, centers = (t.to(cuda_device) for t in (desc.reshape(-1, 128), mask.reshape(-1),
                                                        centers))
    got = tls.lloyd_stats(desc, mask, centers, return_labels=True)
    again = tls.lloyd_stats(desc, mask, centers, return_labels=True)
    want = tls.lloyd_stats_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    _labels_agree(got[3], want[3], mask)
    assert bool((got[3][:2048] == -1).all())
    _close(got[0], want[0], "sums")
    _close(got[1], want[1], "counts")
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-4)
    assert all(_same_bits(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("chunk_size", [None, 100])
def test_fit_steps_and_fisher_encode_on_card_match_cpu(cuda_device, chunk_size):
    desc, mask, w, mu, cov = _gmm_batch(3, 196, 40, 16, seed=2)
    gmm = GmmCodebook(weights=w, means=mu, covariances=cov)
    want = tfisher.fisher_encode_batch(desc, mask, gmm, chunk_size=chunk_size)
    got = tfisher.fisher_encode_batch(
        desc.to(cuda_device), mask.to(cuda_device), gmm.to(cuda_device), chunk_size=chunk_size
    )
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)

    x, m = desc.reshape(-1, 40), mask.reshape(-1)
    new_cpu, ll_cpu = tgmm.em_step(x, m, gmm, 1e-6, chunk_size)
    new_gpu, ll_gpu = tgmm.em_step(x.to(cuda_device), m.to(cuda_device), gmm.to(cuda_device),
                                   1e-6, chunk_size)
    for a, b in zip((new_gpu.weights, new_gpu.means, new_gpu.covariances),
                    (new_cpu.weights, new_cpu.means, new_cpu.covariances)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ll_gpu.cpu(), ll_cpu, rtol=1e-5, atol=0)

    centers = x[:16].clone()
    c_cpu, i_cpu = tkmeans.lloyd_step(x, m, centers, chunk_size)
    c_gpu, i_gpu = tkmeans.lloyd_step(x.to(cuda_device), m.to(cuda_device),
                                      centers.to(cuda_device), chunk_size)
    torch.testing.assert_close(c_gpu.cpu(), c_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(i_gpu.cpu(), i_cpu, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# SIFT kernels: refinement, orientation, descriptor
# ---------------------------------------------------------------------------
SIFT_CFG = tsift.SiftConfig(process_size=64, max_keypoints=96)
REFINE_KW = dict(n_layers=3, steps=5, reach=3, contrast_threshold=0.04, edge_threshold=10.0)


def _blobs(b, size=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    img = np.zeros((b, size, size), np.float32)
    for i in range(b):
        for _ in range(40):
            y, x, s = rng.integers(2, size - 2), rng.integers(2, size - 2), rng.uniform(1, 5)
            img[i] += np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s)) * rng.uniform(40, 200)
    return torch.from_numpy(np.clip(img, 0, 255))


@pytest.fixture(scope="module")
def pyramid():
    """Gaussian levels and DoG of a 3-image batch (built on the CPU)."""
    up = tsift._upscale2x(_blobs(3))
    return tsift._build_pyramids(tsift.gaussian_blur_batch(up, 1.249), SIFT_CFG)


def _refine_both(dogs, img, layer, row, col, valid, counts):
    before = tsw.refine.launches
    got = tsw.refine(dogs, img, layer, row, col, valid, counts=counts, **REFINE_KW)
    again = tsw.refine(dogs, img, layer, row, col, valid, counts=counts, **REFINE_KW)
    want = tsw.refine_reference(dogs, img, layer, row, col, valid, counts=counts, **REFINE_KW)
    torch.cuda.synchronize()
    assert tsw.refine.launches == before + (2 if img.numel() else 0)  # one launch a call
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got.ok, want.ok)
    for name in ("layer", "row", "col"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    for name in ("xr", "xc", "xi", "contrast"):
        # the kernel repeats the plain version's f32 operations (no FMA)
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-5)
    return got


def _ranked_octaves(dogs, budgets, device):
    """Each octave's ranked candidates at its budget, as one refine call's
    arguments (octave after octave, image after image)."""
    parts, counts = [], []
    for dog, budget in zip(dogs, budgets):
        _, layer, r, c, valid = tsift._rank_candidates(dog, budget, SIFT_CFG)
        b, k = valid.shape
        img = torch.arange(b, dtype=torch.int32).repeat_interleave(k)
        parts.append((img, layer.reshape(-1), r.reshape(-1), c.reshape(-1), valid.reshape(-1)))
        counts.append(b * k)
    cand = [torch.cat(field).to(device) for field in zip(*parts)]
    return [d.to(device).contiguous() for d in dogs], *cand, counts


def test_refine_kernel_matches_plain_version(cuda_device, pyramid):
    """Every octave of the SIFT core's call in one launch."""
    _, dogs = pyramid
    budgets = [SIFT_CFG.octave_budget(o) for o in range(len(dogs))]
    assert int(_refine_both(*_ranked_octaves(dogs, budgets, cuda_device)).ok.sum()) > 20


# (octaves, budget of each): the core's 4 octaves at ragged budgets (one
# candidate, none, odd counts), then 1, 7 and 8 octaves (the pyramid's
# DoGs again, at sizes 64..8), and the 16 the kernel takes.
OCTAVE_LAYOUTS = [
    (4, [1, 37, 0, 5]), (1, [29]), (7, [96, 48, 24, 12, 7, 3, 1]),
    (8, [33, 0, 17, 9, 96, 1, 2, 50]), (16, [3] * 16),
]


@pytest.mark.parametrize("layout", OCTAVE_LAYOUTS, ids=lambda l: f"{l[0]}oct")
def test_refine_kernel_in_one_launch_at_ragged_budgets(cuda_device, pyramid, layout):
    _, dogs = pyramid
    n_oct, budgets = layout
    picked = [dogs[o % len(dogs)] for o in range(n_oct)]
    args = _ranked_octaves(picked, budgets, cuda_device)
    got = _refine_both(*args)
    assert got.ok.numel() == sum(args[-1])


def test_refine_kernel_ragged_inputs(cuda_device, pyramid):
    """One candidate, a few, all invalid, and candidates on the 5-px border
    and at positions that are no extrema (they step or are rejected)."""
    dog = pyramid[1][0].to(cuda_device)
    h, w = dog.shape[2:]
    i32 = dict(dtype=torch.int32, device=cuda_device)
    rows = torch.tensor([5, h - 6, 20, 7, 33, 5, 60, 64], **i32)
    cols = torch.tensor([5, w - 6, 21, w - 6, 40, 90, 5, 64], **i32)
    layers = torch.tensor([1, 3, 2, 1, 2, 3, 1, 2], **i32)
    imgs = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], **i32)
    valid = torch.ones(8, dtype=torch.bool, device=cuda_device)
    for n in (1, 3, 8):
        _refine_both([dog], imgs[:n], layers[:n], rows[:n], cols[:n], valid[:n], [n])
    out = _refine_both([dog], imgs, layers, rows, cols, torch.zeros_like(valid), [8])
    assert not out.ok.any() and torch.equal(out.row, rows) and not out.xr.any()
    empty = _refine_both([dog, dog], imgs[:0], layers[:0], rows[:0], cols[:0], valid[:0], [0, 0])
    assert empty.ok.numel() == 0


def _keypoints(atlas, octaves, n, seed=0, n_images=3):
    """Random keypoints over every octave, their scales spread over every
    radius class, some on the image border, one in ten invalid."""
    g = torch.Generator().manual_seed(seed)
    octave = torch.randint(0, octaves.shape[0], (n,), generator=g, dtype=torch.int32)
    h = octaves[octave.long(), 1].cpu().to(torch.int32)
    w = octaves[octave.long(), 2].cpu().to(torch.int32)
    row = (torch.rand(n, generator=g) * h).to(torch.int32)
    col = (torch.rand(n, generator=g) * w).to(torch.int32)
    edge = torch.arange(4, dtype=torch.int32)[: max(0, min(n, 8) - 4)]
    row[:4] = torch.arange(4, dtype=torch.int32)[:n]
    col[4 : 4 + edge.numel()] = w[4 : 4 + edge.numel()] - 1 - edge
    scl = 1.6 * 2.0 ** (torch.rand(n, generator=g) * 2.2)  # radius classes 12..40
    theta = (torch.rand(n, generator=g) * 2 - 1) * np.pi
    valid = torch.rand(n, generator=g) > 0.1
    return dict(
        atlas=atlas, octaves=octaves,
        img=torch.randint(0, n_images, (n,), generator=g, dtype=torch.int32),
        octave=octave, layer=torch.randint(1, 4, (n,), generator=g, dtype=torch.int32),
        row=row, col=col, scl=scl.to(torch.float32), valid=valid,
    ), theta.to(torch.float32)


@pytest.fixture(scope="module")
def atlases(pyramid):
    gauss, _ = pyramid
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = tsift.SiftConfig(process_size=64, max_keypoints=96, atlas_dtype=dtype)
        out[dtype] = tsift._grad_atlas(gauss, cfg)
    return out


def _on(device, kw):
    return {k: v.to(device).contiguous() if torch.is_tensor(v) else v for k, v in kw.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 5, 700])
def test_orientation_kernel_matches_plain_version(cuda_device, atlases, dtype, n):
    kw, _ = _keypoints(*atlases[dtype], n)
    kw["radius"] = tsift._radius_class(kw["scl"], 4.5, SIFT_CFG.ori_radius_classes)
    kw = _on(cuda_device, kw)
    before = tsw.orientation.launches
    got = tsw.orientation(**kw, n_layers=3)
    again = tsw.orientation(**kw, n_layers=3)
    want = tsw.orientation_reference(**kw, n_layers=3)
    torch.cuda.synchronize()
    assert tsw.orientation.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # same f32 operations, each bin summed in the same order
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not got[0][~kw["valid"]].any()
    if n == 700:
        assert set(kw["radius"].tolist()) == set(SIFT_CFG.ori_radius_classes)
        assert got[2].any()


def _check_orientation_kernel(kw):
    before = tsw.orientation.launches
    got = tsw.orientation(**kw, n_layers=3)
    again = tsw.orientation(**kw, n_layers=3)
    want = tsw.orientation_reference(**kw, n_layers=3)
    torch.cuda.synchronize()
    assert tsw.orientation.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not got[0][~kw["valid"]].any()
    return got


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_orientation_kernel_on_one_bin_windows(cuda_device, atlases, dtype):
    """Every pixel of every window falls into one bin (a constant angle),
    so one lane adds the whole window: still bit for bit."""
    atlas, octaves = atlases[dtype]
    atlas = atlas.clone()
    atlas.view(-1, 2)[:, 1] = 0.35  # bin 2
    kw, _ = _keypoints(atlas, octaves, 96, seed=3)
    kw["radius"] = tsift._radius_class(kw["scl"], 4.5, SIFT_CFG.ori_radius_classes)
    got = _check_orientation_kernel(_on(cuda_device, kw))
    valid = kw["valid"].to(cuda_device)
    assert not got[2].any()
    assert (got[0][valid] - 2 * 2 * np.pi / 36).abs().max().item() < 0.1


# Slot counts that end inside a block of the kernel's layout (4 keypoints,
# one warp each) or on its edge, and 2,048 slots with ~18 % valid.
@pytest.mark.parametrize("n", [3, 4, 5, 7, 9, 33, 257, 2048])
def test_orientation_kernel_at_block_edges_and_sparse_slots(cuda_device, atlases, n):
    kw, _ = _keypoints(*atlases["bfloat16"], n, seed=n)
    kw["radius"] = tsift._radius_class(kw["scl"], 4.5, SIFT_CFG.ori_radius_classes)
    if n == 2048:
        g = torch.Generator().manual_seed(4)
        kw["valid"] = torch.rand(n, generator=g) < 0.18
    _check_orientation_kernel(_on(cuda_device, kw))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 5, 700])
def test_descriptor_kernel_matches_plain_version(cuda_device, atlases, dtype, n):
    kw, theta = _keypoints(*atlases[dtype], n, seed=1)
    kw["radius"] = tsift._radius_class(kw["scl"], 3.0 * 1.4142135623730951 * 2.5,
                                       SIFT_CFG.desc_radius_classes)
    kw = _on(cuda_device, dict(kw, theta=theta))
    before = tsw.descriptor.launches
    got = tsw.descriptor(**kw, n_layers=3)
    again = tsw.descriptor(**kw, n_layers=3)
    want = tsw.descriptor_reference(**kw, n_layers=3)
    torch.cuda.synchronize()
    assert tsw.descriptor.launches == before + 2
    assert torch.equal(got, again)
    # the plain version's batched matmul sums the histogram in another order
    diff = (got - want).abs()
    assert diff.max().item() <= 1.0
    assert (diff[kw["valid"]] == 0).float().mean().item() >= 0.99
    assert not got[~kw["valid"]].any()
    assert got.max().item() <= 255.0 and torch.equal(got, got.round())
    if n == 700:
        assert set(kw["radius"].tolist()) == set(SIFT_CFG.desc_radius_classes)


_DESC_MULT = 3.0 * 1.4142135623730951 * 2.5  # window radius per unit of scale


def _check_descriptor_kernel(kw):
    got = tsw.descriptor(**kw, n_layers=3)
    again = tsw.descriptor(**kw, n_layers=3)
    want = tsw.descriptor_reference(**kw, n_layers=3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    diff = (got - want).abs()
    assert diff.max().item() <= 1.0
    assert (diff[kw["valid"]] == 0).float().mean().item() >= 0.99
    assert not got[~kw["valid"]].any()
    return got


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("cls", [24, 32, 40])
def test_descriptor_kernel_at_each_radius_class(cuda_device, atlases, dtype, cls):
    """Every keypoint at the largest scale of one radius class (the whole
    window in play; past 40 the window stays at 40), windows clipped by the
    image border, then one valid keypoint among many invalid ones."""
    n = 96
    kw, theta = _keypoints(*atlases[dtype], n, seed=cls)
    scale = (cls + 0.4) / _DESC_MULT if cls < 40 else 60.0 / _DESC_MULT
    kw["scl"] = torch.full((n,), scale, dtype=torch.float32)
    kw["radius"] = tsift._radius_class(kw["scl"], _DESC_MULT, SIFT_CFG.desc_radius_classes)
    assert set(kw["radius"].tolist()) == {cls}
    kw = _on(cuda_device, dict(kw, theta=theta))
    _check_descriptor_kernel(kw)
    one = torch.zeros_like(kw["valid"])
    one[n // 2] = True
    _check_descriptor_kernel(dict(kw, valid=one))


def test_window_kernels_all_invalid_and_refusals(cuda_device, atlases):
    kw, theta = _keypoints(*atlases["bfloat16"], 6)
    kw["radius"] = torch.full((6,), 12, dtype=torch.int32)
    kw["valid"] = torch.zeros(6, dtype=torch.bool)
    kw = _on(cuda_device, kw)
    t1, t2, second = tsw.orientation(**kw, n_layers=3)
    desc = tsw.descriptor(**kw, theta=theta.to(cuda_device), n_layers=3)
    torch.cuda.synchronize()
    assert not (t1.any() or t2.any() or second.any() or desc.any())
    bad = [
        (TypeError, dict(scl=kw["scl"].double())),
        (TypeError, dict(row=kw["row"].long())),
        (TypeError, dict(atlas=kw["atlas"].half())),
        (ValueError, dict(col=kw["col"][:5].contiguous())),
        (ValueError, dict(octaves=kw["octaves"].cpu())),
        (ValueError, dict(atlas=kw["atlas"][None])),
        (ValueError, dict(layer=kw["layer"].reshape(2, 3))),
    ]
    for err, change in bad:
        with pytest.raises(err):
            tsw.orientation(**dict(kw, **change), n_layers=3)
    dog = torch.zeros((1, 5, 16, 16), device=cuda_device)
    cand = [torch.zeros(2, dtype=torch.int32, device=cuda_device) for _ in range(4)]
    ok = torch.ones(2, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        tsw.refine([dog.double()], *cand, ok, counts=[2], **REFINE_KW)
    with pytest.raises(ValueError):
        tsw.refine([dog[0]], *cand, ok, counts=[2], **REFINE_KW)
    with pytest.raises(ValueError):
        tsw.refine([dog], *cand, ok.cpu(), counts=[2], **REFINE_KW)
    with pytest.raises(ValueError):
        tsw.refine([dog[:, :4].contiguous()], *cand, ok, counts=[2], **REFINE_KW)
    with pytest.raises(ValueError):
        tsw.refine([dog, dog.cpu()], *cand, ok, counts=[1, 1], **REFINE_KW)
    with pytest.raises(ValueError):
        tsw.refine([dog] * 17, *cand, ok, counts=[2] + [0] * 16, **REFINE_KW)


# ---- the ingest kernel: raw uint8 images turned gray and letterboxed ----


def _ingest_chunk(case):
    """One chunk of raw uint8 images of a named case, and its size."""
    rng = np.random.default_rng(11)

    def img(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    if case == "gallery":  # the benchmark's chunk, a slice of its batch array
        return img(64, 500, 667, 3)[16:32], 512
    if case == "ragged":
        return [img(500, 667, 3), img(333, 211), img(640, 480, 4), img(1, 1, 3),
                img(500, 667, 3), img(17, 900), img(512, 300, 3)], 512
    if case == "one_pixel":
        return [img(1, 1, 3)], 512
    if case == "exact_size":  # no resize: copied (as gray)
        return [img(512, 384, 3), img(512, 512)], 512
    return img(4, 123, 77), 96  # a batch array of 2-D grays


@pytest.mark.parametrize("case", ["gallery", "ragged", "one_pixel", "exact_size", "gray"])
def test_ingest_kernel_matches_plain_version(cuda_device, case):
    """Bit for bit, one launch a chunk."""
    images, size = _ingest_chunk(case)
    raw, layout, taps = tsift._chunk_layout(images, size)
    before = tingest.gray_letterbox.launches
    got = tingest.gray_letterbox(torch.from_numpy(raw).to(cuda_device), layout, taps, size)
    torch.cuda.synchronize()
    assert tingest.gray_letterbox.launches == before + 1
    want = tingest.gray_letterbox_reference(torch.from_numpy(raw), layout, taps, size)
    assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)
    host = [tsift._letterbox(tsift._to_gray_u8(im), size) for im in images]
    np.testing.assert_array_equal(got.cpu().numpy(), np.stack(host))


def test_ingest_kernel_launches_once_a_chunk_of_sift_descriptors(cuda_device):
    """20 raw RGB images through ``sift_descriptors``: two chunks of at
    most 16, one launch each, and the host route's descriptors."""
    images = (np.stack([_blobs(1, size=80, seed=s)[0].numpy() for s in range(20)])[..., None]
              * np.array([0.9, 1.0, 0.7])).astype(np.uint8)
    before = tingest.gray_letterbox.launches
    got = tsift.sift_descriptors(images, SIFT_CFG, run_on=cuda_device)
    assert tingest.gray_letterbox.launches == before + 2
    grays = [tsift._letterbox(tsift._to_gray_u8(im), SIFT_CFG.process_size) for im in images]
    want = tsift.sift_descriptors([g.astype(np.float32) for g in grays], SIFT_CFG,
                                  run_on=cuda_device)
    assert tingest.gray_letterbox.launches == before + 2
    for key in ("desc", "mask"):
        np.testing.assert_array_equal(got[key], want[key])


def test_ingest_kernel_refuses_what_it_does_not_take(cuda_device):
    images, size = _ingest_chunk("ragged")
    raw, layout, taps = tsift._chunk_layout(images, size)
    dev_raw = torch.from_numpy(raw).to(cuda_device)
    with pytest.raises(TypeError):
        tingest.gray_letterbox(dev_raw.float(), layout, taps, size)
    with pytest.raises(ValueError):
        tingest.gray_letterbox(dev_raw[::2], layout, taps, size)
    two = layout.copy()
    two[1, 3] = 2
    with pytest.raises(ValueError):
        tingest.gray_letterbox(dev_raw, two, taps, size)
    raw2, layout2, taps2 = tsift._chunk_layout([np.zeros((5, 7, 2), np.uint8)], size)
    with pytest.raises(ValueError):
        tingest.gray_letterbox(torch.from_numpy(raw2).to(cuda_device), layout2, taps2, size)
    with pytest.raises(ValueError):
        tingest.gray_letterbox(dev_raw, layout, taps, 256)  # letterboxed sizes above 256
    with pytest.raises(TypeError):
        tingest.gray_letterbox(dev_raw, torch.from_numpy(layout), taps, size)


# ---- kernels 7 and 8: fused 3x3 conv + ReLU (+ 2x2 pool), float and int8 ----


# (B, H, W, Cin, Cout): odd H and W, Cin = 3, one image, Cout at the
# wrappers' smallest multiple, a Cin that is no multiple of 8, several
# channel chunks and channel blocks.
CONV_SHAPES = [
    (1, 9, 13, 3, 64), (2, 34, 20, 64, 128), (1, 17, 16, 20, 64), (3, 32, 48, 160, 192),
    (1, 1, 5, 8, 64),
]


def _conv_inputs(shape, dtype, device, seed=0):
    b, h, w, ci, co = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, ci, generator=g)
    wt = torch.randn(co, 3, 3, ci, generator=g) / (9 * ci) ** 0.5
    bias = 0.1 * torch.randn(co, generator=g)
    return x.to(device, dtype), wt.to(device), bias.to(device)


def _bf16_ulp(t):
    """One bfloat16 step at each value of t (8 significant bits)."""
    _, exp = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), exp - 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_relu_pool_kernel_matches_plain_version(cuda_device, shape, dtype):
    x, wt, bias = _conv_inputs(shape, dtype, cuda_device)
    before = tconv.conv3x3_relu_maxpool.launches
    got = tconv.conv3x3_relu_maxpool(x, wt.to(dtype), bias)
    again = tconv.conv3x3_relu_maxpool(x, wt.to(dtype), bias)
    want = tconv.conv3x3_relu_maxpool_reference(x, wt, bias)
    torch.cuda.synchronize()
    b, h, w, _, co = shape
    assert got.shape == (b, h // 2, w // 2, co) and got.dtype == dtype
    assert torch.equal(got, again)
    if got.numel():
        assert tconv.conv3x3_relu_maxpool.launches == before + 2
    diff = (got.float() - want.float()).abs()
    if not got.numel():
        return
    if dtype == torch.float32:
        # f32 sums in another order than cuDNN's (TF32 off).
        assert diff.max().item() <= 1e-5 * want.abs().max().item() + 1e-6
    else:
        # Products are exact in both; the f32 sums differ in order, so a
        # value near a bf16 rounding boundary may round one step apart.
        assert bool((diff <= _bf16_ulp(want) + 1e-6).all())
        assert (diff == 0).float().mean().item() >= 0.99


def _check_bf16_conv(x, wt, bias):
    """Kernel 7 in bf16 against its plain version: one bf16 step at most,
    >= 99 % exact, two calls bit-equal, one launch a call.

    The step is taken at the output, but not below 2^-20 of the largest
    output: the tensor cores add the 9 * Cin products in f32 along the
    k-steps, and at 2 x 112^2 x 128 on signed inputs their outputs lie up
    to 2.8e-6 from float64 beyond the final rounding, the plain version's
    up to 7.7e-7 (conv_probe.py, on the H100). An output near zero, a
    cancelling sum, cannot then be held to a bf16 step of its own tiny
    value: there 1 of 802,816 outputs, 1.895e-5 against 1.764e-5."""
    before = tconv.conv3x3_relu_maxpool.launches
    got = tconv.conv3x3_relu_maxpool(x, wt, bias)
    again = tconv.conv3x3_relu_maxpool(x, wt, bias)
    want = tconv.conv3x3_relu_maxpool_reference(x, wt, bias)
    torch.cuda.synchronize()
    assert tconv.conv3x3_relu_maxpool.launches == before + 2
    assert torch.equal(got, again)
    diff = (got.float() - want.float()).abs()
    floor = 2.0**-20 * want.float().abs().max().item()
    assert bool((diff <= _bf16_ulp(want) + max(floor, 1e-6)).all())
    assert (diff == 0).float().mean().item() >= 0.99


# (B, H, W, Cin, Cout): the trunk's conv1 and conv3 sides (224^2 at Cin 64,
# 112^2 at 128, whole 16x16 tiles), sides that cut the last tile (17x33,
# 31x15, 40x24), a Cin of 24 (padded to 32) and 48 (three chunks), Cout
# of 192.
BF16_SHAPES = [
    (1, 224, 224, 64, 64), (2, 112, 112, 128, 128), (1, 17, 33, 64, 64), (2, 31, 15, 24, 128),
    (1, 40, 24, 48, 192),
]


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_relu_pool_bf16_kernel_at_trunk_and_ragged_sides(cuda_device, shape):
    x, wt, bias = _conv_inputs(shape, torch.bfloat16, cuda_device, seed=4)
    _check_bf16_conv(x.relu(), wt, bias)
    _check_bf16_conv(x, wt.to(torch.bfloat16), bias)


def _nan_batch(shape, dtype, device, seed):
    """Conv inputs with one NaN in image 0 at (5, 9), channel 2, and the
    same batch without it."""
    x, wt, bias = _conv_inputs(shape, dtype, device, seed=seed)
    clean = x.clone()
    x[0, 5, 9, 2] = float("nan")
    return x, clean, wt, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_conv_relu_pool_kernel_carries_nan(cuda_device, dtype):
    """NaN where the plain version has NaN (the pooled outputs whose conv
    outputs read the NaN pixel: ReLU and the max carry it); every other
    output as on the batch without the NaN."""
    x, clean, wt, bias = _nan_batch((2, 20, 28, 64, 128), dtype, cuda_device, seed=5)
    got = tconv.conv3x3_relu_maxpool(x, wt.to(dtype), bias)
    before = tconv.conv3x3_relu_maxpool(clean, wt.to(dtype), bias)
    want = tconv.conv3x3_relu_maxpool_reference(x, wt, bias)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert nan[0, 2:4, 4:6].all() and int(nan.sum()) == 4 * 128
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], before[~nan])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("pool", [True, False], ids=["pooled", "unpooled"])
def test_q8_kernel_carries_nan(cuda_device, dtype, pool):
    """The NaN makes image 0's scale NaN, so all its outputs are NaN, as
    the plain version's are; image 1 stays bit for bit with the plain
    version, its int32 sums included (image 0's sums are those of a NaN
    quotient cast to int8, which the plain version leaves undefined)."""
    x, _, wt, bias = _nan_batch((2, 28, 20, 64, 128), dtype, cuda_device, seed=6)
    wq, sw = tconv.quantize_weight(wt)
    wq = wq.contiguous()
    if pool:
        got, acc = tconv.conv3x3_relu_maxpool_q8(x, wq, sw, bias, return_acc=True)
    else:
        got, acc = tconv.conv3x3_q8(x, wq, sw, bias, return_acc=True)
    want, want_acc = tconv.conv3x3_q8_reference(x, wq, sw, bias, pool=pool, return_acc=True)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want[0]).all()) and bool(torch.isnan(got[0]).all())
    assert torch.equal(got[1], want[1]) and torch.equal(acc[1], want_acc[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_q8_kernel_matches_plain_version_bit_for_bit(cuda_device, shape, dtype):
    x, wt, bias = _conv_inputs(shape, dtype, cuda_device, seed=1)
    x[0] *= 3.0  # images on different scales
    wq, sw = tconv.quantize_weight(wt)
    wq = wq.contiguous()
    for pool, relu, b in ((True, True, bias), (False, True, bias), (False, False, None)):
        if pool:
            got, acc = tconv.conv3x3_relu_maxpool_q8(x, wq, sw, b, return_acc=True)
            again = tconv.conv3x3_relu_maxpool_q8(x, wq, sw, b)
        else:
            got, acc = tconv.conv3x3_q8(x, wq, sw, b, relu=relu, return_acc=True)
            again = tconv.conv3x3_q8(x, wq, sw, b, relu=relu)
        want, want_acc = tconv.conv3x3_q8_reference(x, wq, sw, b, pool=pool, relu=relu,
                                                    return_acc=True)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.equal(acc, want_acc), (pool, relu)
        assert torch.equal(got, want), (pool, relu)
        assert torch.equal(got, again)


# (B, H, W, Cin, Cout): sides that are no multiple of kernel 8's 32x8 tile
# (9x13, 13x9, 1x5) and the trunk's 28x28, Cin padded to the 32-channel
# k-step (3, 20, 160), Cout of 64, 192 (128 + 64 channel tiles) and 512.
Q8_EDGE_SHAPES = [
    (1, 9, 13, 3, 512), (1, 28, 28, 160, 192), (1, 1, 5, 20, 64), (1, 28, 28, 20, 512),
    (1, 13, 9, 160, 64),
]
# (pool, relu, bias): pooled with and without bias, unpooled with ReLU and
# no bias, unpooled with bias and no ReLU.
Q8_MODES = [(True, True, True), (True, True, False), (False, True, False), (False, False, True)]


@pytest.mark.parametrize("mode", Q8_MODES, ids=lambda m: "pool{}-relu{}-bias{}".format(*map(int, m)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", Q8_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_q8_kernel_edges_bit_for_bit(cuda_device, shape, dtype, mode):
    pool, relu, with_bias = mode
    x, wt, bias = _conv_inputs(shape, dtype, cuda_device, seed=2)
    wq, sw = tconv.quantize_weight(wt)
    wq = wq.contiguous()
    b = bias if with_bias else None
    if pool:
        got, acc = tconv.conv3x3_relu_maxpool_q8(x, wq, sw, b, return_acc=True)
    else:
        got, acc = tconv.conv3x3_q8(x, wq, sw, b, relu=relu, return_acc=True)
    want, want_acc = tconv.conv3x3_q8_reference(x, wq, sw, b, pool=pool, relu=relu,
                                                return_acc=True)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(acc, want_acc)
    assert torch.equal(got, want)


def test_conv_wrappers_refuse_what_they_do_not_take(cuda_device):
    x, wt, bias = _conv_inputs((2, 8, 8, 64, 64), torch.bfloat16, cuda_device)
    wq, sw = tconv.quantize_weight(wt)
    wq = wq.contiguous()
    with pytest.raises(ValueError):  # Cout not a multiple of 64
        tconv.conv3x3_relu_maxpool(x, wt[:32].contiguous(), bias[:32])
    with pytest.raises(ValueError):
        tconv.conv3x3_q8(x, wq[:32].contiguous(), sw[:32], bias[:32])
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # not contiguous NHWC
    with pytest.raises(ValueError):
        tconv.conv3x3_relu_maxpool(nchw, wt, bias)
    with pytest.raises(ValueError):
        tconv.conv3x3_relu_maxpool_q8(nchw, wq, sw, bias)
    with pytest.raises(TypeError):
        tconv.conv3x3_relu_maxpool(x, wq, bias)
    with pytest.raises(TypeError):
        tconv.conv3x3_relu_maxpool(x.half(), wt, bias)
    with pytest.raises(ValueError):
        tconv.conv3x3_q8(x, wq, sw.cpu(), bias)
    layer = QuantConv(64, 64, kernel_size=3, stride=2).to(cuda_device)
    with pytest.raises(NotImplementedError):
        layer(x.permute(0, 3, 1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_int8_trunk_on_card_matches_cpu(cuda_device, dtype):
    """VGG16's int8 trunk at 64^2: conv1/6/9 through kernel 7, conv3
    through pooled kernel 8, conv2 through QuantConv, the rest cuDNN."""
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    x = x.contiguous(memory_format=torch.channels_last)
    model = tvgg.VGGConvFeatures("vgg16", int8=True).eval()
    with torch.no_grad():
        want = model.to(dtype)(x.to(dtype)).float()
        counts = [f.launches for f in (tconv.conv3x3_relu_maxpool,
                                       tconv.conv3x3_relu_maxpool_q8, tconv.conv3x3_q8)]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            got = model.to(cuda_device)(x.to(cuda_device, dtype)).float().cpu()
    after = [f.launches for f in (tconv.conv3x3_relu_maxpool,
                                  tconv.conv3x3_relu_maxpool_q8, tconv.conv3x3_q8)]
    assert [a - c for a, c in zip(after, counts)] == [3, 1, 1]
    cos = torch.nn.functional.cosine_similarity(got.flatten(1), want.flatten(1))
    assert bool((cos > (0.9999 if dtype == torch.float32 else 0.999)).all()), cos


# -- the serving index: each route on the card against the index on the CPU --

INDEX_MODES = {
    "f32": {},
    "int8": {"quantize": "int8"},
    "screened": {"screen_dim": 6, "rerank": 24, "auto_exact": False},
    "int8_screened": {"quantize": "int8", "screen_dim": 6, "rerank": 24, "auto_exact": False},
}
# (n, D): n no multiple of 8; D = 60 no multiple of 8, which takes the int8
# scan off torch._int_mm; 29 rows scan 32, the whole capacity.
INDEX_SHAPES = [(203, 64), (203, 60), (1000, 136), (29, 8)]


def _index_on_both(vecs, **kw):
    paths = [str(i) for i in range(len(vecs))]
    return (tindex.RetrievalIndex(vecs, paths, device="cuda", **kw),
            tindex.RetrievalIndex(vecs, paths, device="cpu", **kw))


def _index_answers_agree(card, cpu, q, k):
    cs, ci = card.query_vectors(q, k)
    ps, pi = cpu.query_vectors(q, k)
    np.testing.assert_array_equal(ci, pi)
    # float32 sums in another order on the card
    np.testing.assert_allclose(cs, ps, rtol=0, atol=2e-6)


@pytest.mark.parametrize("q", [1, 3, 17, 33])
@pytest.mark.parametrize("shape", INDEX_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", sorted(INDEX_MODES))
def test_index_routes_on_card_match_the_cpu(cuda_device, mode, shape, q):
    n, d = shape
    rng = np.random.default_rng(n + d)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    card, cpu = _index_on_both(vecs, **INDEX_MODES[mode])
    if card.quantize == "int8":
        np.testing.assert_array_equal(card.vectors[:n].cpu().numpy(), cpu.vectors[:n].numpy())
        np.testing.assert_allclose(card.scales[:n].cpu().numpy(), cpu.scales[:n].numpy(),
                                   rtol=5e-7, atol=0)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    _index_answers_agree(card, cpu, queries, k=5)


@pytest.mark.parametrize("q", [1, 3, 17, 33])
@pytest.mark.parametrize("shape", INDEX_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_accumulators_on_card_bit_for_bit(cuda_device, shape, q):
    n, d = shape
    rng = np.random.default_rng(q)
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(q, d)).astype(np.int8)).cuda()
    g8 = torch.from_numpy(rng.integers(-127, 128, size=(n, d)).astype(np.int8)).cuda()
    got = tindex.int8_accumulators(q8, g8)
    assert got.dtype == torch.int32 and got.shape == (q, n)
    assert torch.equal(got, tindex.int8_accumulators_plain(q8, g8))
    assert torch.equal(got.cpu(), tindex.int8_accumulators_plain(q8.cpu(), g8.cpu()))
    full = torch.full((q, d), 127, dtype=torch.int8, device="cuda")
    assert torch.equal(tindex.int8_accumulators(full, full[:1].expand(8, d).contiguous()),
                       torch.full((q, 8), 127 * 127 * d, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("mode", sorted(INDEX_MODES))
def test_index_ties_on_card_in_lax_top_k_order(cuda_device, mode):
    base = np.random.default_rng(5).integers(-9, 10, size=(8, 16)).astype(np.float32)
    vecs = np.concatenate([base, base[[2, 2, 5]], base[[2]] * 2.0, base])
    kw = dict(INDEX_MODES[mode])
    if "rerank" in kw:
        kw["rerank"] = 40
    card, cpu = _index_on_both(vecs, **kw)
    q = np.concatenate([base[[2, 5, 0]], np.zeros((1, 16), np.float32)])
    s, i = card.query_vectors(q, 6)
    assert sorted(i[0, :5]) == [2, 8, 9, 11, 14]
    # Copies may round apart by their positions in a float32 product;
    # where they score alike, the lower index comes first.
    for row_s, row_i in zip(s, i):
        assert all(a < b for a, b, x, y in zip(row_i, row_i[1:], row_s, row_s[1:]) if x == y)
    if card.quantize == "int8" and card.screen_dim is None:
        assert list(i[0, :5]) == [2, 8, 9, 11, 14]  # int32 sums tie exactly
    assert list(i[3]) == [0, 1, 2, 3, 4, 5]  # a zero query scores 0 everywhere


@pytest.mark.parametrize("mode", sorted(INDEX_MODES))
def test_index_add_on_card_across_a_doubling(cuda_device, mode):
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(300, 40)).astype(np.float32)
    paths = [str(i) for i in range(300)]
    card = tindex.RetrievalIndex(vecs[:250], paths[:250], device="cuda", **INDEX_MODES[mode])
    card.add(vecs[250:], paths[250:])  # capacity 256 -> 512
    assert card.vectors.shape[0] == 512 and len(card) == 300
    whole_card, whole_cpu = _index_on_both(vecs, **INDEX_MODES[mode])
    q = rng.normal(size=(5, 40)).astype(np.float32)
    s, i = card.query_vectors(q, 5)
    ws, wi = whole_card.query_vectors(q, 5)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_array_equal(s, ws)
    _index_answers_agree(card, whole_cpu, q, k=5)


def test_prefetch_to_device_delivers_the_batches_on_the_card(cuda_device):
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, size=(4, 32, 32, 3)).astype(np.uint8), f"b{i}")
               for i in range(5)]
    out = []
    for imgs, name in tio.prefetch_to_device(iter(batches), depth=2):
        assert imgs.is_cuda and imgs.dtype == torch.uint8
        out.append((imgs.float().sum().item(), imgs.cpu().numpy(), name))
    assert [name for *_, name in out] == [name for _, name in batches]
    for (_, got, _), (want, _) in zip(out, batches):
        np.testing.assert_array_equal(got, want)


# -- the staged host copies (io/_staging.py) at the three cells' shapes --

# Up: a deep cell's 64 images of 500x667x3 and SIFT's raw 16-image chunk;
# down: the VGG and ResNet cells' 64 VLAD encodings.
STAGED_UP = [(64, 500, 667, 3), (16, 500, 667, 3)]
STAGED_DOWN = [(64, 131584), (64, 131200)]


def _staged_counts(rec) -> tuple[int, int]:
    c = rec.counters()
    return c.get("copy.staged", 0), c.get("copy.plain", 0)


def _ring_buffers(device):
    return [b for (dev, _), ring in tstaging._RINGS.items() if dev == device
            for b in ring.buffers]


@pytest.mark.parametrize("shape", STAGED_UP, ids=lambda s: "x".join(map(str, s)))
def test_staged_upload_equals_the_plain_copy(cuda_device, shape):
    """Three batches back to back with no synchronise between them: a ring
    buffer rewritten before its DMA had read it would corrupt one."""
    rng = np.random.default_rng(sum(shape))
    batches = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]
    with profiling.record() as rec:
        got = [tstaging.upload(b, cuda_device) for b in batches]
    assert _staged_counts(rec) == (3, 0)
    for g, b in zip(got, batches):
        assert g.is_cuda and torch.equal(g, torch.from_numpy(b).to(cuda_device))


@pytest.mark.parametrize("shape", STAGED_DOWN, ids=lambda s: "x".join(map(str, s)))
def test_staged_readback_equals_the_plain_copy(cuda_device, shape):
    """Three readbacks back to back, each tensor rewritten by the stream's
    next kernel: every result is the caller's own pageable memory, shares
    nothing with the ring and keeps its values."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[1])
    tensors = [torch.randn(shape, device=cuda_device, generator=gen) for _ in range(3)]
    want = [t.cpu().numpy() for t in tensors]
    with profiling.record() as rec:
        got = []
        for t in tensors:
            got.append(tstaging.readback(t))
            t.fill_(float("nan"))
    assert _staged_counts(rec) == (3, 0)
    buffers = _ring_buffers(torch.device("cuda", torch.cuda.current_device()))
    assert buffers and all(b.is_pinned() for b in buffers)
    assert sum(b.numel() for b in buffers) <= 48 << 20
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == shape and np.array_equal(g, w)
        assert not torch.from_numpy(g).is_pinned()
        assert not any(np.shares_memory(g, b.numpy()) for b in buffers)


@pytest.mark.parametrize("trunk", ["vgg16", "resnet50"])
def test_a_deep_encode_through_the_staged_copies_equals_the_plain_one(cuda_device, trunk,
                                                                      monkeypatch):
    """Each deep cell's configuration (64 images of 500x667, bf16, int8
    routing, VLAD) gives the same encodings bit for bit by either route."""
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.models.resnet import ResNetTrunk

    torch.manual_seed(0)
    if trunk == "vgg16":
        ext = DeepConvFeature("vgg16", int8=True, dtype=torch.bfloat16, image_size=224,
                              spatial_encoding=True, device=cuda_device)
        k, d = 256, 514
    else:
        ext = DeepConvFeature(module=ResNetTrunk("resnet50", int8=True, int8_min_spatial=7,
                                                 int8_max_spatial=56),
                              dtype=torch.bfloat16, image_size=448, spatial_encoding=True,
                              device=cuda_device)
        k, d = 64, 2050
    centers = torch.randn(k, d, generator=torch.Generator().manual_seed(1))
    encoder = VLADEncoder(ext, kmeans_model=KMeansCodebook(centers=centers), device=cuda_device)
    images = np.random.default_rng(2).integers(0, 256, (64, 500, 667, 3), dtype=np.uint8)
    with profiling.record() as rec:
        staged = encoder.encode(images)
    assert _staged_counts(rec) == (2, 0)
    monkeypatch.setattr(tstaging, "_stages_on", lambda device: False)
    with profiling.record() as rec:
        plain = encoder.encode(images)
    assert _staged_counts(rec) == (0, 2)
    assert staged.dtype == plain.dtype == np.float32 and np.array_equal(staged, plain)


# -- slice 10: ResNet's int8 routes, kernels 1, 3 and 8 at ResNet50's shapes,
# -- and the Siamese trainer on the card against the CPU --

# (B, H, W, Cin, Cout, kernel, stride): ResNet50's int8 1x1, 1x1/2 and 3x3/2
# convs at 224^2 (56^2 to 7^2), odd sides, and maps of fewer than 17 rows,
# which torch._int_mm takes padded.
GEMM_SHAPES = [
    (2, 56, 56, 64, 256, 1, 1), (2, 56, 56, 256, 512, 1, 2), (2, 56, 56, 128, 128, 3, 2),
    (2, 28, 28, 512, 1024, 1, 2), (2, 14, 14, 512, 512, 3, 2), (2, 7, 7, 2048, 512, 1, 1),
    (3, 9, 13, 64, 72, 3, 2), (3, 13, 9, 256, 64, 1, 2), (1, 3, 3, 1024, 2048, 1, 2),
    (1, 2, 2, 64, 64, 1, 1), (1, 7, 7, 512, 512, 3, 2),
]


def _gemm_inputs(shape, dtype, device, seed=0):
    b, h, w, ci, co, k, _ = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, ci, generator=g)
    x[0] *= 3.0  # images on different scales
    wq, sw = tconv.quantize_weight(torch.randn(co, k, k, ci, generator=g) / (k * k * ci) ** 0.5)
    return x.to(device, dtype), wq.contiguous().to(device), sw.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_gemm_route_bit_for_bit(cuda_device, shape, dtype):
    """int8_gemm_conv on the card against quant_conv_reference on the card:
    int32 sums and outputs bit for bit. (Against the CPU they may differ at
    a rounding tie: PyTorch forms ``amax / 127`` as a product with the
    reciprocal on CUDA and exactly on the CPU; tests/test_torch_resnet.py.)"""
    stride, pad = shape[6], shape[5] // 2
    x, wq, sw = _gemm_inputs(shape, dtype, cuda_device)
    bias = torch.linspace(-0.5, 0.5, shape[4], device=cuda_device)
    for b in (None, bias):
        before = tquant.int8_gemm_conv.launches
        got, acc = tquant.int8_gemm_conv(x, wq, sw, b, stride=stride, padding=pad,
                                         return_acc=True)
        want, want_acc = tconv.quant_conv_reference(x, wq, sw, b, stride=stride, padding=pad,
                                                    return_acc=True)
        torch.cuda.synchronize()
        assert tquant.int8_gemm_conv.launches == before + 1
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(acc, want_acc) and torch.equal(got, want)


# The gemm route's convs of ResNet50 at 448^2, two images: (B, H, W, Cin,
# Cout, kernel, stride) of layer2's 1x1 conv1, layer3's 1x1/2 downsample
# and layer3's 3x3/2 conv2.
FUSED_ROUTES = {"1x1": (2, 56, 56, 512, 128, 1, 1), "1x1/2": (2, 56, 56, 512, 1024, 1, 2),
                "3x3/2": (2, 56, 56, 256, 256, 3, 2)}


def _frozen_bn(cout, device, seed):
    """BatchNorm away from identity, as the ResNet cell draws it: weight
    U(0.5, 1.5), bias N(0, 0.1), mean N(0, 0.1), variance U(0.5, 2)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(cout, generator=g).to(device) + 0.5,
            0.1 * torch.randn(cout, generator=g).to(device),
            0.1 * torch.randn(cout, generator=g).to(device),
            1.5 * torch.rand(cout, generator=g).to(device) + 0.5, 1e-5)


def _same_floats(got, want):
    """Equal bits wherever ``want`` is a number, NaN where it is NaN."""
    nan = torch.isnan(want)
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(torch.isnan(got), nan):
        return False
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got[~nan].view(ints), want[~nan].view(ints))


@pytest.mark.parametrize("mode", ["bn", "bn_relu", "bn_residual_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("route", sorted(FUSED_ROUTES))
def test_int8_gemm_epilogue_equals_the_unfused_chain(cuda_device, route, dtype, mode):
    """int8_gemm_conv with BatchNorm (and ReLU, and the residual add) in its
    epilogue against the same call without, followed by ``F.batch_norm``,
    ``+ residual`` and ``torch.relu`` as separate passes on the card, bit
    for bit; image 1 holds a NaN and comes out NaN in both. ``F.batch_norm``
    runs ATen's own kernel on a channels-last bf16 map; a float32 map is
    passed NCHW-contiguous, where it runs that kernel too (a channels-last
    one goes to cuDNN, which rounds otherwise, so the trunk keeps float32
    BatchNorm unfused)."""
    shape = FUSED_ROUTES[route]
    stride, pad = shape[6], shape[5] // 2
    x, wq, sw = _gemm_inputs(shape, dtype, cuda_device, seed=11)
    x[1, 3, 5, 7] = float("nan")
    bn = _frozen_bn(shape[4], cuda_device, seed=12)
    ho = (shape[1] + 2 * pad - shape[5]) // stride + 1
    residual = None
    if mode == "bn_residual_relu":
        g = torch.Generator().manual_seed(13)
        residual = torch.randn(shape[0], ho, ho, shape[4], generator=g).to(cuda_device, dtype)
    relu = mode != "bn"
    before = tepi.gemm_epilogue.launches
    got = tquant.int8_gemm_conv(x, wq, sw, stride=stride, padding=pad, bn=bn, relu=relu,
                                residual=residual)
    assert tepi.gemm_epilogue.launches == before + 1
    y = tquant.int8_gemm_conv(x, wq, sw, stride=stride, padding=pad).permute(0, 3, 1, 2)
    if dtype == torch.float32:
        y = y.contiguous()
    weight, bias, mean, var, eps = bn
    want = torch.nn.functional.batch_norm(y, mean, var, weight, bias, False, 0.0, eps)
    if residual is not None:
        want = want + residual.permute(0, 3, 1, 2)
    if relu:
        want = torch.relu(want)
    want = want.permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert _same_floats(got, want)
    assert bool(torch.isnan(got[1]).all()) and not bool(torch.isnan(got[0]).any())
    assert bool((got[0] < 0).any()) != relu
    if dtype == torch.bfloat16:  # the plain version on the card (in float32 it reaches cuDNN)
        _, acc = tquant.int8_gemm_conv(x, wq, sw, stride=stride, padding=pad, return_acc=True)
        plain = tepi.gemm_epilogue_reference(acc, tconv.activation_scale(x), sw, dtype=dtype,
                                             bn=bn, relu=relu, residual=residual)
        assert _same_floats(got, plain)


def test_quant_conv_routes_on_card_and_refuses_the_rest(cuda_device):
    """Each route of ResNet's convs through the module, bit for bit with
    the plain version on the card's own quantised weights."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 64, 14, 14, generator=g).contiguous(memory_format=torch.channels_last)
    xc = x.to(cuda_device)
    for k, stride, pad in ((1, 1, 0), (1, 2, 0), (3, 2, 1), (3, 1, 1)):
        layer = QuantConv(64, 128, k, stride, pad, bias=False)
        layer.load_state_dict({"weight": torch.randn(128, 64, k, k, generator=g) * 0.05})
        layer = layer.to(cuda_device)
        with torch.no_grad():
            got = layer(xc)
        want = tconv.quant_conv_reference(xc.permute(0, 2, 3, 1).contiguous(), layer.wq,
                                          layer.sw, None, stride=stride, padding=pad)
        assert torch.equal(got, want.permute(0, 3, 1, 2)), (k, stride)
    for k, stride, pad, relu in ((5, 1, 2, False), (3, 2, "SAME", False), (1, 1, 0, True),
                                 (1, 3, 0, False), (7, 2, 3, False)):
        layer = QuantConv(64, 64, k, stride, pad, relu=relu).to(cuda_device)
        with pytest.raises(NotImplementedError):
            layer(xc)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=str)
def test_int8_gemm_conv_refuses_other_dtypes_on_card(cuda_device, dtype):
    """A float16 or float64 map is refused before kernel 8's quantiser
    reads it (those launches read float32 or bf16 only) and before the
    epilogue; the card is left sound."""
    x = torch.randn(2, 14, 14, 64, device=cuda_device).to(dtype)
    wq, sw = tconv.quantize_weight(torch.randn(64, 1, 1, 64, device=cuda_device))
    before = (tquant.int8_gemm_conv.launches, tepi.gemm_epilogue.launches)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tquant.int8_gemm_conv(x, wq.contiguous(), sw, stride=1, padding=0)
    torch.cuda.synchronize()
    assert (tquant.int8_gemm_conv.launches, tepi.gemm_epilogue.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 56, 56, 64, 64), (2, 28, 28, 128, 128),
                                   (2, 14, 14, 256, 256), (2, 7, 7, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_q8_kernel_at_resnet_shapes_without_bias_or_relu(cuda_device, shape, dtype):
    """Kernel 8 as ResNet's 3x3 stride-1 convs call it: unpooled, no bias,
    no ReLU (BatchNorm follows), bit for bit."""
    x, wt, _ = _conv_inputs(shape, dtype, cuda_device, seed=5)
    wq, sw = tconv.quantize_weight(wt)
    wq = wq.contiguous()
    got, acc = tconv.conv3x3_q8(x, wq, sw, None, relu=False, return_acc=True)
    want, want_acc = tconv.conv3x3_q8_reference(x, wq, sw, None, pool=False, relu=False,
                                                return_acc=True)
    torch.cuda.synchronize()
    assert torch.equal(acc, want_acc) and torch.equal(got, want)
    assert bool((got < 0).any())  # no ReLU


def test_vlad_and_lloyd_kernels_at_resnet50_width(cuda_device):
    """Kernels 1 and 3 at D = 2,050 (ResNet50's 2,048 channels and the two
    coordinates) with 49-row sets, as phase 10 runs them."""
    desc, mask, centers = (t.to(cuda_device) for t in _margin_batch(16, 49, 2050, 256, seed=6))
    out, labels = tagg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    ref, ref_labels = tagg.vlad_aggregate_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    _labels_agree(labels, ref_labels, mask)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item() + 1e-5
    flat, fmask = desc.reshape(-1, 2050), mask.reshape(-1)
    got = tls.lloyd_stats(flat, fmask, centers, return_labels=True)
    want = tls.lloyd_stats_reference(flat, fmask, centers, return_labels=True)
    torch.cuda.synchronize()
    _labels_agree(got[3], want[3], fmask)
    _close(got[0], want[0], "sums")
    _close(got[1], want[1], "counts")
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-4)


def _route_counts():
    return tconv.conv3x3_q8.launches, tquant.int8_gemm_conv.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_int8_resnet50_on_card_matches_cpu(cuda_device, dtype):
    """resnet50 with every block conv int8 (window 1-64) at 64^2: 13 kernel-8
    launches and 39 int8_gemm_conv calls a forward, in bf16 each with its
    BatchNorm in the epilogue (``conv.int8_gemm_fused``; float32 keeps
    the BatchNorm a pass of its own), layer 4's 2x2 maps of 8 rows
    included; cosine > 0.999 per image against the CPU. Each of the
    52 int8 convs quantises on its own device (scales one ulp apart for a
    few % of images and channels, tests/test_torch_resnet.py), and a value
    at a rounding boundary moves one int8 step; over the depth that gave
    cosines of 0.9997 in float32 on the card (each conv is held bit for bit
    against its plain version on the card by the tests above)."""
    from pyvisim_tpu_torch.models import resnet as tresnet

    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(7))
    x = x.contiguous(memory_format=torch.channels_last)
    model = tresnet.ResNetTrunk("resnet50", int8=True, int8_min_spatial=1,
                                int8_max_spatial=64).eval()
    with torch.no_grad():
        want = model.to(dtype)(x.to(dtype)).float()
        before = _route_counts()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
                profiling.record() as rec:
            got = model.to(cuda_device)(x.to(cuda_device, dtype)).float().cpu()
    after = _route_counts()
    assert [a - b for a, b in zip(after, before)] == [13, 39]
    counts = rec.counters()
    assert [counts.get(k, 0) for k in ("conv.int8_k8", "conv.int8_gemm",
                                       "conv.int8_gemm_fused")] == [
        13, 39, 39 if dtype == torch.bfloat16 else 0]
    cos = torch.nn.functional.cosine_similarity(got.flatten(1), want.flatten(1))
    assert bool((cos > 0.999).all()), cos


def test_deep_conv_feature_with_int8_resnet_on_card(cuda_device):
    """DeepConvFeature's one-image probe at 64^2 reaches int8 convs of 4 rows;
    descriptors against the CPU at cosine > 0.999, as above."""
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.models import resnet as tresnet

    module = tresnet.ResNetTrunk("resnet50", int8=True, int8_min_spatial=1, int8_max_spatial=64)
    ext = DeepConvFeature(module=module, image_size=64, device="cuda")
    img = (np.random.default_rng(8).random((70, 50, 3)) * 255).astype(np.uint8)
    assert ext(img).shape == (4, 2050)
    cpu = DeepConvFeature(module=tresnet.ResNetTrunk("resnet50", int8=True, int8_min_spatial=1,
                                                     int8_max_spatial=64),
                          image_size=64, device="cpu")
    a, b = torch.from_numpy(ext(img)).flatten(), torch.from_numpy(cpu(img)).flatten()
    assert float(torch.nn.functional.cosine_similarity(a, b, dim=0)) > 0.999


def test_siamese_step_on_card_matches_cpu(cuda_device):
    """One nt_xent loss and its gradients (vgg11, 2 convs, 64^2, B=8) on the
    card in float32 with TF32 off against the CPU: the loss to rtol 1e-5,
    each gradient to 1e-3 * its max |CPU| (f32 sums in other orders)."""
    from pyvisim_tpu_torch.models import siamese as tsiam

    model = tsiam.SiameseEmbedder("vgg11", embed_dim=32, trunk_convs=2)
    x = torch.rand(8, 64, 64, 3, generator=torch.Generator().manual_seed(9))
    labels = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3])
    out = {}
    for dev in ("cpu", cuda_device):
        state = tsiam.create_train_state(model, tsiam.adamw(1e-3), seed=1, device=dev)
        with tsiam.full_f32():
            loss = tsiam.make_loss_fn(model, "nt_xent")(state.params, x.to(dev), labels.to(dev))
            loss.backward()
        out[str(dev)] = loss.item(), {k: p.grad.cpu() for k, p in state.params.items()}
        step = tsiam.train_step(model, tsiam.adamw(1e-3))
        state, l2 = step(state, x.to(dev), labels.to(dev))
        assert state.step == 1 and bool(torch.isfinite(l2))
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k in gc:
        assert (gg[k] - gc[k]).abs().max() <= 1e-3 * gc[k].abs().max(), k


# Phase 11's Lloyd shapes, the rows cut to 1,024: K = 102 is no multiple of
# the 128-center tile and D = 102 none of the 16-deep stage; D = 131,584 is
# the VGG16 VLAD encoding's width.
@pytest.mark.parametrize("d", [102, 131584])
def test_lloyd_kernel_at_the_clustering_shapes(cuda_device, d):
    """As ``test_lloyd_kernel_matches_plain_version``, but the inertia of
    both against the float64 inertia: within rel 1e-5, or where it is
    larger within three float32 rounding steps grown with sqrt(D) of each
    row's |x|^2 + |c|^2, the terms whose difference the squared distance
    is. At D = 131,584 that slack is the larger: the two float32 sums
    differ by ~4e-4 relative."""
    n, k = 1024, 102
    g = torch.Generator(device=cuda_device).manual_seed(d)
    protos = torch.randn(k, d, device=cuda_device, generator=g)
    labels = torch.randint(0, k, (n,), device=cuda_device, generator=g)
    desc = protos[labels] + 0.1 * torch.randn(n, d, device=cuda_device, generator=g)
    centers = protos + 0.01 * torch.randn(k, d, device=cuda_device, generator=g)
    mask = (torch.rand(n, device=cuda_device, generator=g) > 0.1).float()
    mask[0] = 0.375
    got = tls.lloyd_stats(desc, mask, centers, return_labels=True)
    want = tls.lloyd_stats_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    _labels_agree(got[3], want[3], mask)
    _close(got[0], want[0], "sums")
    assert torch.equal(got[1], want[1])
    xd, cd = desc.double(), centers[got[3].clamp(min=0).long()].double()
    exact = float((((xd - cd) ** 2).sum(1) * mask).sum())
    terms = float((((xd**2).sum(1) + (cd**2).sum(1)) * mask).sum())
    tol = max(1e-5 * exact, 3 * 2.0**-24 * d**0.5 * terms)
    assert abs(float(got[2]) - exact) <= tol and abs(float(want[2]) - exact) <= tol
    again = tls.lloyd_stats(desc, mask, centers, return_labels=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_spectral_on_card_matches_cpu(cuda_device):
    """N = 512 rows in 8 separate blobs: the kNN affinity equal to the CPU's
    on every row whose kept and dropped distances differ by more than 1e-5
    relative, and the projector of the 8 columns that span eigenvalue 0
    (8 components) within 1e-4."""
    from pyvisim_tpu_torch.ops import spectral as tspectral

    rng = np.random.default_rng(11)
    centers = rng.normal(scale=20.0, size=(8, 16))
    x = torch.from_numpy((centers[np.arange(512) % 8] + rng.normal(size=(512, 16)))
                         .astype(np.float32))
    xd = x.double()
    d2 = torch.sort(torch.cdist(xd, xd) ** 2, dim=1).values
    clear = (d2[:, 11] - d2[:, 10]) > 1e-5 * d2[:, 11]
    got = tspectral.knn_affinity(x.to(cuda_device), 10).cpu()
    want = tspectral.knn_affinity(x, 10)
    assert int(clear.sum()) > 400
    assert torch.equal(got[clear], want[clear])
    e_card = tspectral.spectral_embedding(x.to(cuda_device), 8).cpu().double()
    e_cpu = tspectral.spectral_embedding(x, 8).double()
    assert (e_card @ e_card.T - e_cpu @ e_cpu.T).abs().max() <= 1e-4


@pytest.mark.parametrize("method", ["kmeans", "spectral"])
def test_cluster_and_return_labels_on_card(cuda_device, method):
    from pyvisim_tpu_torch._utils import cluster_and_return_labels

    before = tls.lloyd_stats.launches
    x = np.random.default_rng(12).normal(size=(1024, 64)).astype(np.float32)
    labels = cluster_and_return_labels(x, method=method, n_clusters=102)
    assert labels.shape == (1024,) and labels.dtype == np.int32
    assert 0 <= labels.min() and labels.max() < 102 and len(np.unique(labels)) <= 102
    assert tls.lloyd_stats.launches > before


def test_kernels_1_and_2_match_the_golden_fixtures(cuda_device):
    """Kernels 1 and 2 on the fixtures that pin the JAX package
    (``tests/test_golden.py``), at its rtol 1e-5 and atol 1e-6: a check on
    the card that does not rest on the plain versions."""
    import pathlib

    from pyvisim_tpu_torch._config import MODEL_FILES_PATH
    from pyvisim_tpu_torch.ops import GmmCodebook, fisher_encode, load_codebook, vlad_encode

    with np.load(pathlib.Path(__file__).parent / "testdata" / "golden_encodings.npz") as f:
        g = {k: torch.from_numpy(f[k]).to(cuda_device) for k in f.files}
    gmm = GmmCodebook(weights=g["gmm_w"], means=g["gmm_m"], covariances=g["gmm_c"])
    real = load_codebook(MODEL_FILES_PATH / "gmm_k256_sift_pca.npz").to(cuda_device)
    v0, f0 = tagg.vlad_aggregate_batched.launches, tgs.gmm_stats_batched.launches
    got = {
        "vlad": vlad_encode(g["desc"], g["mask"], g["centers"]),
        "vlad_p05": vlad_encode(g["desc"], g["mask"], g["centers"], power_norm_weight=0.5),
        "fisher": fisher_encode(g["desc"], g["mask"], gmm),
        "fisher_real": fisher_encode(g["desc_real"], None, real),
    }
    assert tagg.vlad_aggregate_batched.launches == v0 + 2
    assert tgs.gmm_stats_batched.launches == f0 + 2
    for name, out in got.items():
        np.testing.assert_allclose(out.cpu().numpy(), g[name].cpu().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# The mesh paths on the card: a world of one rank under NCCL, and one of two
# ranks sharing cuda:0 under gloo (which NCCL refuses). The ranks import this
# file for its ``job_*`` functions.
# ---------------------------------------------------------------------------
def _card_mesh():
    from pyvisim_tpu_torch.parallel import make_mesh

    return make_mesh()


def _launches():
    return {"vlad": tagg.vlad_aggregate_batched.launches,
            "lloyd": tls.lloyd_stats.launches}


def job_card_kmeans(x, k, n_iters):
    from pyvisim_tpu_torch.parallel import distributed_kmeans_fit

    before = _launches()["lloyd"]
    history = {}
    cb, _ = distributed_kmeans_fit(torch.from_numpy(x).cuda(), k, _card_mesh(), n_iters=n_iters,
                                   history=history)
    return cb.centers.cpu().numpy(), history["lloyd_inertia"][0], _launches()["lloyd"] - before


def job_card_encode(desc, mask, centers):
    from pyvisim_tpu_torch.parallel import sharded_encode

    def core(d, m, model, pca):
        return tvlad.vlad_encode_batch(d, m, model.centers)

    before = _launches()["vlad"]
    out = sharded_encode(core, desc, mask, KMeansCodebook(centers=centers), None,
                         _card_mesh())
    return out.cpu().numpy(), _launches()["vlad"] - before


def job_card_index(gallery, queries, quantize):
    mesh = _card_mesh()
    paths = [str(i) for i in range(len(gallery))]
    index = tindex.RetrievalIndex(torch.from_numpy(gallery).cuda(), paths, quantize=quantize,
                                  mesh=mesh)
    return [index.query_vectors(q, 5) for q in (queries[:1], queries)]


@pytest.fixture(scope="module", params=[(1, "nccl"), (2, "gloo")], ids=["nccl1", "gloo2"])
def card_world(request):
    """A world on the card, its kernels built once here before the ranks
    start, so that they only load them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pyvisim_tpu_torch.ops.cuda import _build
    from pyvisim_tpu_torch.parallel.local import LocalWorld

    _build.build(["aggregate", "gmm_stats"])
    n, backend = request.param
    world = LocalWorld(n, backend, "cuda", threads=None, timeout_s=300)
    yield world
    world.close()


def test_distributed_kmeans_on_card_matches_kmeans_fit(card_world):
    """The same seeding (k-means++ over all rows, below the 4,096-row
    subsample) and the same number of Lloyd steps: on one rank the centers
    and inertias equal kmeans_fit's bit for bit; on two ranks within 1e-4 *
    max|ref| + 1e-5 and rel 1e-5. Each rank launches kernel 3 once a step."""
    desc, _, _ = _margin_batch(1, 4000, 64, 16, seed=3)
    x = desc[0].numpy()
    out = card_world.run(job_card_kmeans, x, 16, 6)
    history = {}
    cb, _ = tkmeans.kmeans_fit(x, 16, max_iters=6, tol=-1.0, history=history)
    want, want_steps = cb.centers.cpu().numpy(), history["lloyd_inertia"][0]
    for centers, steps, launches in out:
        assert launches == 6
        if card_world.n == 1:
            np.testing.assert_array_equal(centers, want)
            assert steps == want_steps
        else:
            np.testing.assert_allclose(centers, want, rtol=0,
                                       atol=1e-4 * np.abs(want).max() + 1e-5)
            np.testing.assert_allclose(steps, want_steps, rtol=1e-5)


def test_sharded_encode_on_card_matches_encode(card_world):
    """Kernel 1 on each rank's block of 13 sets (padded to divide): on one
    rank equal to vlad_encode_batch bit for bit, on two within 1e-5."""
    desc, mask, centers = _margin_batch(13, 196, 130, 32, seed=4)
    out = card_world.run(job_card_encode, desc.numpy(), mask.numpy(), centers.numpy())
    want = tvlad.vlad_encode_batch(desc.cuda(), mask.cuda(), centers.cuda()).cpu().numpy()
    for got, launches in out:
        assert launches == 1
        if card_world.n == 1:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_sharded_index_query_on_card_matches_unsharded(card_world, quantize):
    """A gallery of 1,000 rows split over the ranks: Q=1 and Q=8 queries
    give the unsharded index's ids in the same order, and its scores to
    1e-6."""
    rng = np.random.default_rng(5)
    gallery = rng.normal(size=(1000, 256)).astype(np.float32)
    gallery[700] = gallery[10]  # a tie across the two ranks' blocks
    queries = np.concatenate([gallery[10:11], rng.normal(size=(7, 256)).astype(np.float32)])
    index = tindex.RetrievalIndex(torch.from_numpy(gallery).cuda(),
                                  [str(i) for i in range(1000)], quantize=quantize)
    want = [index.query_vectors(q, 5) for q in (queries[:1], queries)]
    for answers in card_world.run(job_card_index, gallery, queries, quantize):
        for (s, i), (ws, wi) in zip(answers, want):
            np.testing.assert_array_equal(i, wi)
            np.testing.assert_allclose(s, ws, rtol=0, atol=1e-6)
        assert list(answers[0][1][0, :2]) == [10, 700]


def _vit_state(trunk, seed):
    """A state dict for ``trunk`` far from its initialisation, as the ViT
    cell draws it: weights with variance 1 / fan_in, biases N(0, 0.1),
    LayerNorm weights U(0.5, 1.5), LayerScale U(0.2, 0.6), embeddings
    N(0, 0.2)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in trunk.state_dict().items():
        if name.endswith("gamma"):
            t = 0.2 + 0.4 * torch.rand(p.shape, generator=g)
        elif name.endswith(("norm1.weight", "norm2.weight")):
            t = 0.5 + torch.rand(p.shape, generator=g)
        elif name.endswith("bias"):
            t = 0.1 * torch.randn(p.shape, generator=g)
        elif name.endswith("weight"):
            t = torch.randn(p.shape, generator=g) / float(np.prod(p.shape[1:])) ** 0.5
        else:
            t = 0.2 * torch.randn(p.shape, generator=g)
        out[name] = t
    return out


@pytest.mark.parametrize("facet", ["value", "token"])
def test_vit_trunk_in_bf16_on_card_matches_float32_on_the_fused_route(cuda_device, facet):
    """A small ViT (width 192, three heads of 64 as ViT-g's, SwiGLU, 112^2:
    65 tokens) in bf16 against the same trunk in float32 on the card: 1 - cos
    an image within 2e-4 (the bf16 roundings of maps and weights read
    2.3e-5 to 3.1e-5 on the CPU; the fused kernel also rounds its softmax
    weights to bf16; a softmax scale off by sqrt(2) reads ~1e-2). Every bf16
    attention call takes the fused route and none the plain math, and every
    SwiGLU and LayerScale-add-norm pass the kernels; the float32 trunk takes
    the plain math and the plain passes."""
    spec = tvit.ViTSpec(192, 3, 3, "swiglu", 512)
    f32 = tvit.ViTTrunk(spec, layer=2, facet=facet, image_size=112, device=cuda_device)
    state = _vit_state(f32, 11)
    f32.load_state_dict(state)
    bf = tvit.ViTTrunk(spec, layer=2, facet=facet, image_size=112, device=cuda_device,
                       dtype=torch.bfloat16)
    bf.load_state_dict(state)
    x = torch.rand(4, 3, 112, 112, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        with profiling.record() as rec:
            got = bf(x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
        bf_counts = rec.counters()
        with profiling.record() as rec:
            want = f32(x)
        f32_counts = rec.counters()
    assert got.shape == want.shape == (4, 192, 8, 8) and got.dtype == torch.bfloat16
    gap = 1.0 - torch.nn.functional.cosine_similarity(got.flatten(1).double(),
                                                      want.flatten(1).double())
    assert float(gap.max()) < 2e-4
    calls = 2 if facet == "value" else 3
    # A SwiGLU a block; an ls1 + norm2 and an ls2 + next norm1 a block, but
    # the token facet's block 2, whose ls2 add ends the trunk.
    passes = {"swiglu": calls, "add_norm": 4 if facet == "value" else 5}
    assert bf_counts == {f"attn.{tvit.FUSED_ROUTE}": calls, "vit.tokens": 4 * 65,
                         **{f"vit.{k}.kernel": n for k, n in passes.items()}}
    assert f32_counts == {"attn.math": calls, "vit.tokens": 4 * 65,
                          **{f"vit.{k}.plain": n for k, n in passes.items()}}


@pytest.mark.parametrize("n", [17, 65, 1370, 2309])
def test_vit_fused_attention_on_card_matches_the_plain_math(cuda_device, n):
    """The fused route on the strided q, k, v views of one qkv projection (64
    images x 24 heads x 1,370 tokens x 64, the ViT-g cell's call; 16 images
    x 32 heads x 2,309 tokens x 128, the DINOv3 cell's; and odd token
    counts) against the plain math on the same bf16 inputs, three images of
    them: within 2^-7 of the largest |v| (the output's bf16 rounding and the
    kernel's bf16 softmax weights each move it by at most 2^-9 of that)."""
    b = {1370: 64, 2309: 16}.get(n, 3)
    heads, hd = (32, 128) if n == 2309 else (24, 64)
    attn = tvit.Attention(heads * hd, heads, device=cuda_device, dtype=torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = 1.2 * torch.randn(b, n, 3, heads, hd, device=cuda_device, generator=g)
    q, k, v = qkv.to(torch.bfloat16).permute(2, 0, 3, 1, 4)
    assert tvit.attention_route(q) == tvit.FUSED_ROUTE
    with torch.inference_mode():
        got = attn.core(q, k, v)
        want = tvit.attention_reference(q[:3], k[:3], v[:3], attn.scale)
    assert got.shape == (b, heads, n, hd) and got.dtype == torch.bfloat16
    err = (got[:3].float() - want.float()).abs().max()
    assert float(err) <= 2.0 ** -7 * float(v.abs().max())


@pytest.mark.parametrize("rows", [87680, 1, 65, 1371, 36944])
def test_vit_swiglu_kernel_equals_the_torch_passes_bit_for_bit(cuda_device, rows):
    """SwiGLU in one launch against ``F.silu(x1) * x2`` on the strided halves
    of the same bf16 map: at the ViT-g cell's 87,680 x 2 x 4,096 (64 images
    x 1,370 tokens), the DINOv3 cell's 36,944 x 2 x 8,192 (16 images x 2,309
    tokens) and at odd row counts, equal bit for bit."""
    hidden = {87680: 4096, 36944: 8192}.get(rows, 264)
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x12 = (3.0 * torch.randn(rows, 2 * hidden, device=cuda_device, generator=g)).to(torch.bfloat16)
    launches = tvp.swiglu.launches
    with torch.inference_mode():
        got = tvp.swiglu(x12)
        x1, x2 = x12.chunk(2, dim=-1)
        want = torch.nn.functional.silu(x1) * x2
    assert tvp.swiglu.launches == launches + 1
    assert got.shape == (rows, hidden) and got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_vit_swiglu_kernel_rounds_silu_as_aten_on_every_bf16_input(cuda_device):
    """Every one of the 65,536 bf16 values as ``x1``, against ``F.silu``'s
    ATen kernel, with ``x2`` 1 (the product exact) and ``x2`` drawn: equal
    bit for bit wherever the input is a number; NaN where it is NaN."""
    x1 = torch.arange(-2**15, 2**15, dtype=torch.int32, device=cuda_device).to(torch.int16)
    x1 = x1.view(torch.bfloat16).reshape(-1, 64)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    for x2 in (torch.ones_like(x1), torch.randn(x1.shape, device=cuda_device,
                                                 generator=g).to(torch.bfloat16)):
        with torch.inference_mode():
            got = tvp.swiglu(torch.cat([x1, x2], dim=1))
            want = torch.nn.functional.silu(x1) * x2
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16))


@pytest.mark.parametrize("width", [192, 384, 768, 1024, 1536, 2056, 4096])
def test_vit_add_norm_kernel_equals_addcmul_and_layer_norm_bit_for_bit(cuda_device, width):
    """LayerScale + residual add and the LayerNorm after it in one launch, on
    a residual stream drawn as the trunk carries it (a per-channel offset,
    gamma U(0.2, 0.6), LayerNorm weight U(0.5, 1.5), bias N(0, 0.1)):
    x_new bit for bit with ``torch.addcmul`` and the normed map bit for bit
    with ``F.layer_norm`` of it (the kernel takes its statistics as ATen's
    kernel does; summed in another order, a few entries in a million lie a
    bf16 step or two off). At 1,536 the ViT-g cell's 87,680 rows, at 4,096
    the DINOv3 cell's 36,944 with its eps 1e-5, elsewhere 1,371; 2,056 and
    4,096 stream their rows through device memory instead of registers."""
    rows = {1536: 87680, 4096: 36944}.get(width, 1371)
    eps = 1e-5 if width == 4096 else 1e-6
    g = torch.Generator(device=cuda_device).manual_seed(width)
    draw = lambda *shape: torch.randn(*shape, device=cuda_device, generator=g)
    x = (3.0 * draw(rows, width) + 2.0 * draw(width)).to(torch.bfloat16)
    y = draw(rows, width).to(torch.bfloat16)
    gamma = (0.2 + 0.4 * torch.rand(width, device=cuda_device, generator=g)).to(torch.bfloat16)
    weight = (0.5 + torch.rand(width, device=cuda_device, generator=g)).to(torch.bfloat16)
    bias = (0.1 * draw(width)).to(torch.bfloat16)
    launches = tvp.add_norm.launches
    with torch.inference_mode():
        x_new, h = tvp.add_norm(x, y, gamma, weight, bias, eps)
        want_x = torch.addcmul(x, y, gamma)
        want_h = torch.nn.functional.layer_norm(want_x, (width,), weight, bias, eps)
    assert tvp.add_norm.launches == launches + 1
    assert torch.equal(x_new.view(torch.int16), want_x.view(torch.int16))
    assert torch.equal(h.view(torch.int16), want_h.view(torch.int16))


@pytest.mark.parametrize("images, tokens, dim, hd", [(16, 2309, 4096, 128), (3, 70, 4096, 128),
                                                     (2, 17, 1536, 64), (1, 6, 256, 16)])
def test_vit_rope_kernel_equals_the_plain_route_bit_for_bit(cuda_device, images, tokens, dim, hd):
    """The RoPE rotation in one in-place launch against its plain route
    (float32 products and sums, one rounding to bf16) on the same bf16
    ``qkv``: at the DINOv3 cell's 16 images x 2,309 tokens x 3 x 4,096
    (32 heads of 128, 5 prefix rows), at ragged row counts and at other
    head widths, equal bit for bit, the prefix rows and the v third left as
    they were. The angles are drawn over several turns, so that cos and sin
    take every sign."""
    patches = tokens - 5
    g = torch.Generator(device=cuda_device).manual_seed(tokens)
    qkv = (3.0 * torch.randn(images, tokens, 3 * dim, device=cuda_device, generator=g))
    qkv = qkv.to(torch.bfloat16)
    angles = 20.0 * torch.rand(patches, hd // 2, device=cuda_device, generator=g)
    table = torch.stack([angles.cos(), angles.sin()])
    launches = tvp.rope.launches
    with torch.inference_mode():
        got = tvp.rope(qkv.clone(), table)
        want = tvp.rope_reference(qkv.clone(), table)
    assert tvp.rope.launches == launches + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got[:, :5], qkv[:, :5])
    assert torch.equal(got[..., 2 * dim:], qkv[..., 2 * dim:])
    assert float((got[:, 5:, :2 * dim] != qkv[:, 5:, :2 * dim]).float().mean()) > 0.9


def test_vit_rope_trunk_in_bf16_on_card_matches_float32(cuda_device):
    """A small DINOv3-shaped trunk (width 256, two heads of 128 as ViT-7B's,
    4 registers, patch 16, RoPE, no qkv bias, SwiGLU, the final-norm facet)
    at 128^2 (69 tokens) in bf16 against the same trunk in float32 on the
    card: 1 - cos an image within 2e-4. Every bf16 rotation takes the
    kernel, every attention call the fused route and every float pass its
    kernel; the float32 trunk takes the plain routes."""
    spec = tvit.ViTSpec(256, 3, 2, "swiglu", 512, patch=16, registers=4, position="rope",
                        ln_eps=1e-5, qkv_bias=False)
    f32 = tvit.ViTTrunk(spec, facet="norm", image_size=128, device=cuda_device)
    state = _vit_state(f32, 13)
    f32.load_state_dict(state)
    bf = tvit.ViTTrunk(spec, facet="norm", image_size=128, device=cuda_device,
                       dtype=torch.bfloat16)
    bf.load_state_dict(state)
    x = torch.rand(4, 3, 128, 128, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        with profiling.record() as rec:
            got = bf(x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
        bf_counts = rec.counters()
        with profiling.record() as rec:
            want = f32(x)
        f32_counts = rec.counters()
    assert got.shape == want.shape == (4, 256, 8, 8) and got.dtype == torch.bfloat16
    gap = 1.0 - torch.nn.functional.cosine_similarity(got.flatten(1).double(),
                                                      want.flatten(1).double())
    assert float(gap.max()) < 2e-4
    passes = {"rope": 3, "swiglu": 3, "add_norm": 6}
    assert bf_counts == {f"attn.{tvit.FUSED_ROUTE}": 3, "vit.tokens": 4 * 69,
                         **{f"vit.{k}.kernel": n for k, n in passes.items()}}
    assert f32_counts == {"attn.math": 3, "vit.tokens": 4 * 69,
                          **{f"vit.{k}.plain": n for k, n in passes.items()}}


def test_vit_pass_launch_refused_by_the_library_raises(cuda_device):
    """A launch the library refuses (a width the kernels do not take, passed
    past the wrapper's checks) raises with CUDA's message and counts no
    launch."""
    lib = tvp._library()
    x = torch.zeros(4, 24, dtype=torch.bfloat16, device=cuda_device)
    index, stream = tagg.launch_target(x.device)
    with pytest.raises(RuntimeError, match="SwiGLU kernel failed"):
        tvp._launched(lib, lib.vit_swiglu(x.data_ptr(), x.data_ptr(), 4, 12, index, stream),
                      "SwiGLU")
    err = lib.vit_add_norm(*[x.data_ptr()] * 5, 1e-6, x.data_ptr(), x.data_ptr(), 4, 12, index,
                           stream)
    with pytest.raises(RuntimeError, match="invalid argument"):
        tvp._launched(lib, err, "add-norm")
    t = torch.zeros(2, 1, 12, device=cuda_device)
    err = lib.vit_rope(x.data_ptr(), t.data_ptr(), 1, 4, 3, 8, 12, index, stream)
    with pytest.raises(RuntimeError, match="invalid argument"):
        tvp._launched(lib, err, "RoPE")
    torch.cuda.synchronize()
