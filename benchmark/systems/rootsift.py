"""RootSIFT -> VLAD, as the program runs it: ``RootSIFT`` at the
configuration's keypoint budget and process size under ``VLADEncoder``."""
from __future__ import annotations

import torch

FEATURES = "extract_batch_device"


def make_weights(cfg: dict, seed: int, device) -> dict:
    """RootSIFT has no weights."""
    return {}


def build(cfg: dict, weights: dict, centers: torch.Tensor, device):
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import RootSIFT
    from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook

    ex = cfg["extractor"]
    ext = RootSIFT(max_keypoints=ex["max_keypoints"], process_size=ex["process_size"],
                   device=device)
    vlad = cfg["vlad"]
    return VLADEncoder(ext, kmeans_model=KMeansCodebook(centers=centers),
                       power_norm_weight=vlad["power_norm_weight"],
                       norm_order=vlad["norm_order"], epsilon=vlad["epsilon"], device=device)
