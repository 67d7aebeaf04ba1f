"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch; the suite's conftest.py sets up JAX, so leave it out there:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from pyvisim_tpu_torch.ops import fisher as tfisher
from pyvisim_tpu_torch.ops import gmm as tgmm
from pyvisim_tpu_torch.ops import kmeans as tkmeans
from pyvisim_tpu_torch.ops import vlad as tvlad
from pyvisim_tpu_torch.ops.codebooks import GmmCodebook
from pyvisim_tpu_torch.ops.cuda import aggregate as tagg
from pyvisim_tpu_torch.ops.cuda import gmm_stats as tgs
from pyvisim_tpu_torch.ops.cuda import lloyd_stats as tls

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


# (B, N, D, K): the main path's widths; ragged row, depth, column and
# center tiles; and enough centers that the accumulator takes 128-, 64-
# and 32-column slices.
SHAPES = [
    (4, 196, 514, 16), (3, 17, 33, 5), (2, 300, 130, 70), (1, 50, 514, 300),
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
    assert torch.equal(labels, ref_labels)
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


# (B, N, D, K): the encode and EM widths, ragged row/column/component
# tiles, one set cut into several row segments, K = 1 and one row.
GMM_SHAPES = [
    (2, 196, 257, 256), (3, 17, 33, 7), (1, 3000, 257, 1), (1, 2500, 514, 7),
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
    assert torch.equal(got[3], want[3])
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
