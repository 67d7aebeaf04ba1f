"""Losses (port of ``pyvisim_tpu/losses``): segmentation and retrieval."""
from ._losses import (
    FocalLoss,
    HybridFocalDiceLoss,
    MultiClassDiceLoss,
    contrastive_loss,
    dice_loss,
    focal_loss,
    hybrid_focal_dice_loss,
    margin_softmax_loss,
    nt_xent_loss,
    soft_dice_score,
    triplet_loss,
)

__all__ = [
    "MultiClassDiceLoss",
    "FocalLoss",
    "HybridFocalDiceLoss",
    "dice_loss",
    "focal_loss",
    "hybrid_focal_dice_loss",
    "triplet_loss",
    "contrastive_loss",
    "nt_xent_loss",
    "margin_softmax_loss",
    "soft_dice_score",
]
