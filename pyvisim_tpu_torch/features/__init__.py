"""Feature extractors (port of ``pyvisim_tpu/features``)."""
from ._features import SIFT, DeepConvFeature, FeatureExtractorBase, Lambda, RootSIFT

__all__ = ["SIFT", "RootSIFT", "Lambda", "DeepConvFeature", "FeatureExtractorBase"]
