"""Losses: segmentation (Dice / Focal / Hybrid) and retrieval (triplet /
contrastive / NT-Xent / margin softmax).

Port of ``pyvisim_tpu/losses/_losses.py``: plain functions on tensors,
differentiable with autograd, whose values and gradients are those of the
JAX functions under ``jax.grad``. Where JAX takes a maximum, so does the
port, with ``torch.maximum`` against a tensor (a tie splits the gradient
evenly, as ``jnp.maximum`` does; ``clamp_min`` would give it all to one
side). The class wrappers are ``nn.Module``s with the JAX wrappers'
constructor checks.

Inputs may be numpy arrays or tensors; numpy arrays become tensors on the
CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = [
    "soft_dice_score",
    "dice_loss",
    "focal_loss",
    "hybrid_focal_dice_loss",
    "triplet_loss",
    "contrastive_loss",
    "nt_xent_loss",
    "margin_softmax_loss",
    "MultiClassDiceLoss",
    "FocalLoss",
    "HybridFocalDiceLoss",
]


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: on a tie each side gets half the gradient."""
    return torch.maximum(x, x.new_tensor(c))


def soft_dice_score(output, target, smooth: float = 0.0, eps: float = 1e-7, dims=None):
    """Soft dice score ``(2 |a.b| + smooth) / max(|a| + |b| + smooth, eps)``,
    summed over ``dims`` (all dims when None)."""
    output, target = _t(output), _t(target)
    if dims is not None:
        intersection = torch.sum(output * target, dim=dims)
        cardinality = torch.sum(output + target, dim=dims)
    else:
        intersection = torch.sum(output * target)
        cardinality = torch.sum(output + target)
    return (2.0 * intersection + smooth) / _max(cardinality + smooth, eps)


def _probabilities(y_pred: torch.Tensor, mode: str) -> torch.Tensor:
    return torch.softmax(y_pred, dim=1) if mode == "multiclass" else torch.sigmoid(y_pred)


def dice_loss(
    y_pred,
    y_true,
    *,
    mode: str = "multiclass",
    classes=None,
    log_loss: bool = False,
    from_logits: bool = True,
    smooth: float = 0.0,
    eps: float = 1e-7,
    ignore_index: Optional[int] = None,
):
    """Multi-class soft-dice loss on ``(B, C, H, W)`` tensors; classes absent
    from the mask contribute zero loss."""
    y_pred, y_true = _t(y_pred), _t(y_true)
    if y_pred.dim() != 4 or y_true.dim() != 4:
        raise ValueError(
            f"Expected 4D input tensors, got {y_pred.dim()} for y_pred and "
            f"{y_true.dim()} for y_true"
        )
    if from_logits:
        y_pred = _probabilities(y_pred, mode)
    b, c = y_true.shape[0], y_pred.shape[1]
    dims = (0, 2)
    y_true = y_true.reshape(b, c, -1)
    y_pred = y_pred.reshape(b, c, -1)
    if ignore_index is not None:
        y_pred = y_pred * (y_true != ignore_index)
    scores = soft_dice_score(y_pred, y_true.to(y_pred.dtype), smooth=smooth, eps=eps, dims=dims)
    loss = -torch.log(_max(scores, eps)) if log_loss else 1.0 - scores
    present = torch.sum(y_true, dim=dims) > 0  # zero loss for absent classes
    loss = loss * present.to(loss.dtype)
    if classes is not None:
        loss = loss[torch.as_tensor(classes, device=loss.device)]
    return torch.mean(loss)


def focal_loss(
    y_pred,
    y_true,
    *,
    mode: str = "multiclass",
    alpha=None,
    normalize_weights: bool = True,
    gamma: float = 2.0,
    from_logits: bool = True,
    ignore_index: Optional[int] = None,
):
    """Focal loss on ``(B, C, H, W)`` tensors with one-hot targets; pixels of
    ``ignore_index`` are weighted out rather than dropped, as in JAX."""
    y_pred, y_true = _t(y_pred), _t(y_true)
    if y_pred.dim() != 4 or y_true.dim() != 4:
        raise ValueError(f"Expected 4D input tensors, got {y_pred.dim()} and {y_true.dim()}")
    labels = torch.argmax(y_true, dim=1)  # (B, H, W)
    if from_logits:
        y_pred = _probabilities(y_pred, mode)
    if mode == "multiclass":
        num_classes = y_pred.shape[1]
        probs = torch.movedim(y_pred, 1, -1).reshape(-1, num_classes)  # (N, C)
        labels_flat = labels.reshape(-1)
        p_t = probs.gather(1, labels_flat[:, None])[:, 0]
        if alpha is None:
            alpha = torch.ones(num_classes, dtype=probs.dtype, device=probs.device) / num_classes
        else:
            alpha = torch.as_tensor(alpha, dtype=probs.dtype, device=probs.device)
            if normalize_weights:
                alpha = alpha / torch.sum(alpha)
        alpha_t = alpha[labels_flat]
    else:
        probs = y_pred.reshape(-1)
        labels_flat = labels.reshape(-1).to(probs.dtype)
        p_t = probs * labels_flat + (1 - probs) * (1 - labels_flat)
        alpha_t = (
            alpha * labels_flat + (1 - alpha) * (1 - labels_flat) if alpha is not None else 1.0
        )
    valid = (labels_flat != ignore_index) if ignore_index is not None else None
    focal_weight = alpha_t * (1 - p_t) ** gamma
    loss = focal_weight * (-torch.log(_max(p_t, 1e-7)))
    if valid is not None:
        loss = loss * valid
        return torch.sum(loss) / _max(torch.sum(valid).to(loss.dtype), 1.0)
    return torch.mean(loss)


def _check_blend(dice_weight: float, focal_weight: float) -> None:
    if not dice_weight + focal_weight == 1.0:
        raise ValueError(
            "Sum of dice_weight and focal_weight must be equal to 1.0, got "
            f"{dice_weight} + {focal_weight} = {dice_weight + focal_weight}"
        )


def hybrid_focal_dice_loss(
    y_pred,
    y_true,
    *,
    mode: str = "multiclass",
    alpha=None,
    gamma: float = 2.0,
    from_logits: bool = True,
    ignore_index: Optional[int] = None,
    dice_weight: float = 0.5,
    focal_weight: float = 0.5,
    smooth: float = 1e-5,
    eps: float = 1e-7,
):
    """Convex blend of focal and dice losses; the weights must sum to 1. Only
    the focal term masks ``ignore_index``, as in JAX."""
    _check_blend(dice_weight, focal_weight)
    f = focal_loss(
        y_pred, y_true, mode=mode, alpha=alpha, gamma=gamma,
        from_logits=from_logits, ignore_index=ignore_index,
    )
    d = dice_loss(y_pred, y_true, mode=mode, from_logits=from_logits, smooth=smooth, eps=eps)
    return focal_weight * f + dice_weight * d


# ---------------------------------------------------------------------------
# Retrieval losses
# ---------------------------------------------------------------------------
def _l2n(x) -> torch.Tensor:
    x = _t(x)
    return x / _max(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def triplet_loss(anchor, positive, negative, margin: float = 0.2):
    """Triplet margin loss on L2-normalised embeddings ``(B, D)``."""
    a, p, n = _l2n(anchor), _l2n(positive), _l2n(negative)
    d_ap = torch.sum((a - p) ** 2, dim=-1)
    d_an = torch.sum((a - n) ** 2, dim=-1)
    return torch.mean(_max(d_ap - d_an + margin, 0.0))


def contrastive_loss(emb1, emb2, same_label, margin: float = 1.0):
    """Contrastive (pair) loss: pull same-label pairs, push the others to
    ``margin``. ``same_label``: ``(B,)`` in {0, 1}."""
    d = torch.sqrt(torch.sum((_l2n(emb1) - _l2n(emb2)) ** 2, dim=-1) + 1e-12)
    same = torch.as_tensor(same_label, dtype=d.dtype, device=d.device)
    return torch.mean(same * d**2 + (1 - same) * _max(margin - d, 0.0) ** 2)


def nt_xent_loss(embeddings, labels, temperature: float = 0.1):
    """Supervised NT-Xent (InfoNCE over same-label positives) on ``(B, D)``."""
    z = _l2n(embeddings)
    sim = (z @ z.T) / temperature
    b = z.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=z.device)
    sim = torch.where(eye, torch.full_like(sim, -torch.inf), sim)
    labels = torch.as_tensor(labels, device=z.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    log_prob = sim - torch.logsumexp(sim, dim=1, keepdim=True)
    n_pos = torch.sum(pos, dim=1)
    pos_count = torch.clamp_min(n_pos, 1).to(sim.dtype)
    loss = -torch.sum(torch.where(pos, log_prob, torch.zeros_like(log_prob)), dim=1) / pos_count
    has_pos = (n_pos > 0).to(sim.dtype)
    return torch.sum(loss * has_pos) / _max(torch.sum(has_pos), 1.0)


def margin_softmax_loss(
    embeddings,
    labels,
    class_weights,
    *,
    margin: float = 0.5,
    scale: float = 64.0,
    kind: str = "arcface",
):
    """Large-margin softmax over L2-normalised embeddings and class weights:
    ``kind='arcface'`` uses cos(theta + m), ``kind='cosface'`` cos(theta) - m.

    :param embeddings: ``(B, E)``
    :param labels: ``(B,)`` int class ids
    :param class_weights: ``(C, E)`` learnable class centers
    """
    z = _l2n(embeddings)
    w = _l2n(class_weights)
    cos = torch.clamp(z @ w.T, -1.0 + 1e-7, 1.0 - 1e-7)  # (B, C)
    labels = torch.as_tensor(labels, device=z.device).long()
    # A label outside [0, C) gets an all-zero row, as jax.nn.one_hot gives it.
    one_hot = (labels[:, None] == torch.arange(w.shape[0], device=z.device)).to(cos.dtype)
    if kind == "arcface":
        cos_margin = torch.cos(torch.arccos(cos) + margin)
    elif kind == "cosface":
        cos_margin = cos - margin
    else:
        raise ValueError(f"Unknown margin-softmax kind: {kind!r}")
    logits = scale * (one_hot * cos_margin + (1.0 - one_hot) * cos)
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(one_hot * log_probs, dim=-1))


# ---------------------------------------------------------------------------
# Module wrappers
# ---------------------------------------------------------------------------
def _check_mode(mode: str) -> None:
    if mode not in {"binary", "multiclass"}:
        raise ValueError(
            f"Unknown mode: {mode}. Supported modes are 'multiclass' and 'binary'."
        )


class MultiClassDiceLoss(nn.Module):
    """Module over :func:`dice_loss`."""

    def __init__(
        self,
        mode: str,
        classes=None,
        log_loss: bool = False,
        from_logits: bool = True,
        smooth: float = 0.0,
        eps: float = 1e-7,
        ignore_index: Optional[int] = None,
    ) -> None:
        super().__init__()
        _check_mode(mode)
        self.kwargs = dict(
            mode=mode, classes=classes, log_loss=log_loss, from_logits=from_logits,
            smooth=smooth, eps=eps, ignore_index=ignore_index,
        )

    def forward(self, y_pred, y_true):
        return dice_loss(y_pred, y_true, **self.kwargs)


class FocalLoss(nn.Module):
    """Module over :func:`focal_loss`."""

    def __init__(
        self,
        mode: str,
        alpha=None,
        normalize_weights: bool = True,
        gamma: float = 2.0,
        from_logits: bool = True,
        ignore_index: Optional[int] = None,
    ) -> None:
        super().__init__()
        _check_mode(mode)
        self.kwargs = dict(
            mode=mode, alpha=alpha, normalize_weights=normalize_weights,
            gamma=gamma, from_logits=from_logits, ignore_index=ignore_index,
        )

    def forward(self, y_pred, y_true):
        return focal_loss(y_pred, y_true, **self.kwargs)


class HybridFocalDiceLoss(nn.Module):
    """Module over :func:`hybrid_focal_dice_loss`. The default weights (1, 1)
    are those of the JAX wrapper, whose check refuses them: pass two that
    sum to 1."""

    def __init__(
        self,
        mode: str,
        alpha=None,
        gamma: float = 2.0,
        from_logits: bool = True,
        ignore_index: Optional[int] = None,
        dice_weight: float = 1.0,
        focal_weight: float = 1.0,
        smooth: float = 1e-5,
        eps: float = 1e-7,
    ) -> None:
        super().__init__()
        _check_blend(dice_weight, focal_weight)
        self.kwargs = dict(
            mode=mode, alpha=alpha, gamma=gamma, from_logits=from_logits,
            ignore_index=ignore_index, dice_weight=dice_weight,
            focal_weight=focal_weight, smooth=smooth, eps=eps,
        )

    def forward(self, y_pred, y_true):
        return hybrid_focal_dice_loss(y_pred, y_true, **self.kwargs)
