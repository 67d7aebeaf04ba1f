"""Exceptions for pyvisim_tpu_torch (port of ``pyvisim_tpu/_errors.py``)."""


class InvalidImageError(Exception):
    """Raised when an input is not a valid image."""

    def __init__(self, message: str = "Input is not a valid image."):
        super().__init__(message)


class CodebookError(Exception):
    """Raised when a codebook (KMeans/GMM/PCA) is missing, malformed, or
    dimensionally incompatible with the feature extractor feeding it."""


class WeightsNotFoundError(CodebookError):
    """Raised when a pretrained weights artifact is not present on disk."""
