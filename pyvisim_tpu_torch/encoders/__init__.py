"""Encoder API (port of ``pyvisim_tpu/encoders``, VLAD for now)."""
from ._base_encoder import GMMWeights, ImageEncoderBase, KMeansWeights
from .vlad import VLADEncoder

__all__ = ["VLADEncoder", "KMeansWeights", "GMMWeights", "ImageEncoderBase"]
