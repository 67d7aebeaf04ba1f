"""SiameseEncoder: the trained embedding network as a similarity encoder.

Port of ``pyvisim_tpu/encoders/siamese.py``: a ``models.siamese``
embedder behind the encoder surface (``encode``, ``similarity_score``,
``generate_encoding_map``), so that ``eval.py`` and ``RetrievalIndex``
take its embeddings as they take VLAD or Fisher vectors.

A ragged batch is resized image by image at each image's own shape, as the
port's ``DeepConvFeature`` does: the JAX package's padding buckets bound
its compiled shapes, which eager PyTorch does not have. So an image's
embedding does not depend on its batchmates.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from .._base_classes import SimilarityMetric
from .._config import resolve_device
from .._utils import cosine_similarity
from ..models.siamese import SiameseEmbedder, embed
from ..ops.resize import masked_linear_resize
from ._base_encoder import _encode_paths_to_map

__all__ = ["SiameseEncoder"]


class SiameseEncoder(SimilarityMetric):
    """Encode images with a (trained) Siamese embedding network.

    :param model: a ``SiameseEmbedder`` (the template; its own parameters
        are not used).
    :param params: its parameters by name, such as ``TrainState.params``
        or a restored checkpoint's; copied to ``device`` (later training
        of the state leaves the encoder as it was).
    :param image_size: input resolution; images of another size are
        resized with antialiased bilinear taps.
    :param similarity_func: batch similarity over embeddings (default:
        cosine on ``device``).
    :param device: where the network runs; None means CUDA.
    """

    def __init__(
        self,
        model: SiameseEmbedder,
        params: Mapping[str, torch.Tensor],
        image_size: int = 224,
        similarity_func: Callable | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        # A copy, as JAX's arrays are values: training on does not move the encoder.
        self.params = {k: torch.as_tensor(v).detach().to(self.device, copy=True)
                       for k, v in params.items()}
        self.image_size = image_size
        self.similarity_func = similarity_func or functools.partial(
            cosine_similarity, device=self.device)

    @classmethod
    def from_train_state(cls, model: SiameseEmbedder, state, **kwargs) -> "SiameseEncoder":
        """Build from a ``models.siamese.TrainState``."""
        return cls(model, state.params, **kwargs)

    @property
    def output_dim(self) -> int:
        return self.model.embed_dim

    def _preprocess(self, images: np.ndarray) -> torch.Tensor:
        """uint8/float ``(B, H, W, 3)`` -> ``(B, S, S, 3)`` float32 in [0, 1],
        resized only when the size differs."""
        x = torch.as_tensor(images).to(self.device).to(torch.float32) / 255.0
        if x.shape[1] != self.image_size or x.shape[2] != self.image_size:
            x = masked_linear_resize(x, self.image_size)
        return x

    def encode(self, images: Iterable[np.ndarray] | np.ndarray) -> np.ndarray:
        """Images -> L2-normalised embeddings ``(B, embed_dim)`` float32."""
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        if isinstance(images, np.ndarray) and images.ndim == 4:
            x = self._preprocess(images)
        else:
            images = [np.asarray(i) for i in images]
            if len({i.shape for i in images}) == 1:
                x = self._preprocess(np.stack(images))
            else:
                x = torch.cat([self._preprocess(i[None]) for i in images])
        return embed(self.model, self.params, x).to(torch.float32).cpu().numpy()

    def similarity_score(self, images1, images2) -> np.ndarray:
        v1 = self.encode(images1)
        v2 = self.encode(images2)
        return np.float32(self.similarity_func(v1, v2))

    def generate_encoding_map(
        self, image_paths: Iterable[str], batch_size: int = 64, save_path: str | None = None
    ) -> dict[str, np.ndarray] | None:
        """``{image_path: embedding}``, decoded on the host and encoded in
        batches of ``batch_size``; with ``save_path`` appended to an HDF5
        file instead (see ``ImageEncoderBase.generate_encoding_map``)."""
        return _encode_paths_to_map(self.encode, image_paths, batch_size, save_path)

    def __repr__(self) -> str:
        return (
            f"SiameseEncoder(cfg={self.model.cfg_name}, "
            f"embed_dim={self.model.embed_dim}, image_size={self.image_size})"
        )
