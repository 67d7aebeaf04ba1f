"""Encoder API (port of ``pyvisim_tpu/encoders``)."""
from ._base_encoder import GMMWeights, ImageEncoderBase, KMeansWeights, load_encoding_map
from .fisher_vector import FisherVectorEncoder
from .pipeline import Pipeline
from .siamese import SiameseEncoder
from .vlad import VLADEncoder

__all__ = [
    "VLADEncoder",
    "FisherVectorEncoder",
    "Pipeline",
    "SiameseEncoder",
    "KMeansWeights",
    "GMMWeights",
    "ImageEncoderBase",
    "load_encoding_map",
]
