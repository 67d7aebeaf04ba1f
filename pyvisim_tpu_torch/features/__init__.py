"""Feature extractors (port of ``pyvisim_tpu/features``)."""
from ._features import DeepConvFeature, FeatureExtractorBase

__all__ = ["DeepConvFeature", "FeatureExtractorBase"]
