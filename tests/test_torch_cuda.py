"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch; the suite's conftest.py sets up JAX, so leave it out there:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from pyvisim_tpu_torch.ops import vlad as tvlad
from pyvisim_tpu_torch.ops.cuda import aggregate as tagg

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
