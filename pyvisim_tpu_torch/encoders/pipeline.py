"""Pipeline: multi-encoder concatenation.

Port of ``pyvisim_tpu/encoders/pipeline.py`` (a "pipeline" is encoder
*concatenation*, not stage pipelining). Encoders that hold the same
feature-extractor instance share one extraction pass, and the descriptors
stay on the device between them.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable

import numpy as np
import torch

from .. import profiling
from .._base_classes import SimilarityMetric
from .._config import get_logger
from .._utils import cosine_similarity
from ._base_encoder import ImageEncoderBase, _encode_paths_to_map, check_desired_output

__all__ = ["Pipeline"]


class Pipeline(SimilarityMetric):
    """Computes feature vectors with a set of descriptor-based encoders and
    concatenates them (always flattened, as in the reference).

    :param encoders: list of ImageEncoderBase instances.
    :param similarity_func: batch similarity function returning an
        (N, M) matrix; None means cosine similarity on the first encoder's
        device.
    """

    _logger = get_logger("pipeline")

    def __init__(
        self,
        encoders: list[ImageEncoderBase],
        similarity_func: Callable | None = None,
    ):
        self._check_valid_encoders(encoders)
        self.encoders = encoders
        if similarity_func is None and encoders:
            similarity_func = functools.partial(cosine_similarity, device=encoders[0].device)
        self._similarity_func = similarity_func

    def _check_valid_encoders(self, encoders: list[ImageEncoderBase]) -> None:
        for encoder in encoders:
            if not isinstance(encoder, ImageEncoderBase):
                raise ValueError(
                    f"Pipeline only accepts instances of ImageEncoderBase, "
                    f"not {type(encoder)}"
                )

    def encode(self, images: Iterable[np.ndarray] | np.ndarray | torch.Tensor) -> np.ndarray:
        """Encode images with every encoder and hstack the results, with one
        extraction pass per distinct extractor instance; ``images`` as for
        ``ImageEncoderBase.encode``. Each member encodes through its own
        engine (``_encode_descriptors``), so a member on a mesh pads and
        splits the batch there exactly as its ``encode`` does."""
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        if not isinstance(images, (np.ndarray, torch.Tensor)):
            images = list(images)

        with profiling.span("encode", root=True):
            # Members on their extractor's mesh share its per-rank blocks, the
            # others its whole batch.
            features: dict[tuple, tuple] = {}
            for enc in self.encoders:
                key = (id(enc.feature_extractor), enc._encodes_blocks())
                if key not in features:
                    features[key] = enc._extract(images)

            all_encodings = []
            for enc in self.encoders:
                desc, mask, n = features[(id(enc.feature_extractor), enc._encodes_blocks())]
                saved_flatten = enc.flatten
                enc.flatten = True
                try:
                    all_encodings.append(enc._encode_descriptors(desc, mask, n))
                finally:
                    enc.flatten = saved_flatten
            return np.hstack(all_encodings)

    def generate_encoding_map(
        self,
        image_paths: Iterable[str],
        batch_size: int = 64,
        save_path: str | None = None,
    ) -> dict[str, np.ndarray] | None:
        """``{path: concatenated_vector}``, decoded on the host and encoded in
        device batches; ``save_path`` appends to HDF5 as
        ``ImageEncoderBase.generate_encoding_map`` does."""
        return _encode_paths_to_map(self.encode, image_paths, batch_size, save_path)

    @property
    def similarity_func(self):
        return self._similarity_func

    @similarity_func.setter
    def similarity_func(self, func: Callable):
        dummy1, dummy2 = np.random.rand(10, 10), np.random.rand(10, 10)
        self._similarity_func = check_desired_output(func, dummy1, dummy2)

    def similarity_score(
        self,
        images1: Iterable[np.ndarray] | np.ndarray,
        images2: Iterable[np.ndarray] | np.ndarray,
    ) -> np.ndarray:
        """Encode both batches and apply ``similarity_func``."""
        vector1 = self.encode(images1)
        vector2 = self.encode(images2)
        return np.float32(self.similarity_func(vector1, vector2))

    def fit(
        self,
        images: Iterable[np.ndarray],
        *,
        n_clusters: int,
        dim_reduction_factor: int | None = None,
        **kwargs,
    ) -> None:
        """Train every member encoder's vocabulary on the same images with
        its ``learn``."""
        images = list(images) if not isinstance(images, np.ndarray) else images
        for enc in self.encoders:
            self._logger.info("Fitting %s ...", type(enc).__name__)
            enc.learn(
                images,
                n_clusters=n_clusters,
                dim_reduction_factor=dim_reduction_factor,
                **kwargs,
            )

    def __repr__(self) -> str:
        encoders_str = "\n".join(str(e) for e in self.encoders)
        sim_name = getattr(self._similarity_func, "__name__", str(self._similarity_func))
        return (
            f"Pipeline(\nencoders=[{encoders_str}],\n"
            f"similarity_func={sim_name})"
        )
