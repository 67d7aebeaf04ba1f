"""PCA training on the device.

Port of ``pyvisim_tpu/ops/pca.py``: the masked mean and the ``(D, D)``
covariance in one f32 product, then ``torch.linalg.eigh`` on the
descriptors' device, with sklearn's ``svd_flip`` sign rule.
"""
from __future__ import annotations

import torch

from .._config import resolve_device
from .codebooks import PcaProjector

__all__ = ["pca_fit", "projector_from_moments"]


def _moments(x: torch.Tensor, mask: torch.Tensor):
    n = mask.sum().clamp_min(1.0)
    mean = (x * mask[:, None]).sum(dim=0) / n
    xc = (x - mean) * mask[:, None]
    cov = (xc.T @ xc) / (n - 1.0).clamp_min(1.0)
    return mean, cov


def pca_fit(
    x,
    n_components: int,
    *,
    mask=None,
    whiten: bool = False,
    device=None,
) -> PcaProjector:
    """Fit a PCA projector on descriptors ``x (N, D)`` (optionally masked),
    on ``device`` (None means CUDA).

    Components are sorted by decreasing explained variance; each is signed
    so that its largest-magnitude loading is positive (sklearn's
    ``svd_flip``).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask).to(device=dev, dtype=torch.float32)
    mean, cov = _moments(x, mask)
    return projector_from_moments(mean, cov, n_components, whiten=whiten)


def projector_from_moments(
    mean: torch.Tensor,
    cov: torch.Tensor,
    n_components: int,
    *,
    whiten: bool = False,
) -> PcaProjector:
    """A :class:`PcaProjector` from a ``(D,)`` mean and ``(D, D)``
    covariance."""
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    idx = torch.argsort(-eigvals)[:n_components]
    components = eigvecs[:, idx].T
    explained = eigvals[idx].clamp_min(0.0)
    rows = torch.arange(components.shape[0], device=components.device)
    signs = torch.sign(components[rows, components.abs().argmax(dim=1)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return PcaProjector(
        mean=mean,
        components=(components * signs[:, None]).contiguous(),
        explained_variance=explained,
        whiten=whiten,
    )
