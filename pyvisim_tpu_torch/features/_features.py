"""Feature extractors: DeepConvFeature.

Port of the deep half of ``pyvisim_tpu/features/_features.py``: a VGG
trunk (``models/vgg.py``) whose chosen conv map is flattened into
descriptors, with a batched device path. SIFT, RootSIFT and Lambda come
with a later slice.
"""
from __future__ import annotations

import contextlib
import os
from functools import wraps
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from .._base_classes import FeatureExtractorBase
from .._config import get_logger, resolve_device
from ..models import vgg as vgg_lib
from ..ops.resize import masked_linear_resize

logger = get_logger("features")

__all__ = ["DeepConvFeature", "FeatureExtractorBase"]


def _check_output_shape(func) -> Callable:
    """Ensure extractor output is a 2-D numpy array of shape (N, output_dim):
    ``None`` becomes a (0, D) array; torch inputs are rejected."""

    @wraps(func)
    def wrapper(self, *args, **kwargs) -> np.ndarray:
        if torch.is_tensor(args[0]):
            raise TypeError(
                "Torch images are not supported on this path. Please convert to NumPy."
            )
        feat_vecs = func(self, *args, **kwargs)
        if feat_vecs is None:
            logger.info("No feature vectors found. Returning empty array.")
            return np.zeros((0, self.output_dim), dtype=np.float32)
        feat_vecs = np.asarray(feat_vecs)
        if feat_vecs.ndim != 2:
            raise ValueError(
                f"Feature extractor output must be 2D. Got shape {feat_vecs.shape}."
            )
        if feat_vecs.shape[1] != self.output_dim:
            raise ValueError(
                f"Expected feat_vecs.shape[1] == {self.output_dim}, "
                f"but got {feat_vecs.shape[1]}."
            )
        return feat_vecs

    return wrapper


class DeepConvFeature(FeatureExtractorBase):
    """Deep convolutional feature extractor over a VGG trunk.

    Flattens the chosen conv layer's post-ReLU map to ``(Hf*Wf, C)``
    descriptors in (h, w) row-major order and optionally appends the
    normalised ``(x/Wf, y/Hf)`` coordinates, x first, for ``C+2`` dims (514
    for VGG16's last conv). Preprocessing divides by 255 and resizes with
    antialiased bilinear taps, with no ImageNet normalisation, as the
    reference's code does.

    :param cfg_name: VGG variant ("vgg11"/"vgg16"/"vgg19"); ignored when a
        custom ``module`` is given.
    :param params: a torchvision-named state dict (a torchvision VGG's, or
        ``models.vgg.params_from_jax`` of the JAX package's params); None ->
        deterministic random initialisation (seed 0).
    :param layer_index: conv layer to capture (negative from the end).
    :param spatial_encoding: append (x/Wf, y/Hf) to each descriptor.
    :param image_size: input resolution (default 224).
    :param transform: optional callable ``(B, H, W, 3) uint8 tensor ->
        (B, image_size, image_size, 3) float in [0, 1]`` replacing the
        default resize.
    :param dtype: ``torch.float32`` runs the trunk with cuDNN's TF32 off;
        ``torch.bfloat16`` runs it in bf16, channels-last. Descriptors keep
        this dtype; the encoders cast them to float32 before VLAD.
    :param module: optional ``nn.Module`` mapping ``(B, 3, S, S)`` to a
        ``(B, C, Hf, Wf)`` map, used in place of the VGG trunk; ``params``,
        if given, is loaded into it.
    :param int8: the int8 trunk is not ported yet and raises.
    :param device: where the trunk runs; None means CUDA.
    """

    def __init__(
        self,
        cfg_name: str = "vgg16",
        params: Mapping | None = None,
        layer_index: int = -1,
        spatial_encoding: bool = True,
        image_size: int = 224,
        transform: Callable | None = None,
        dtype: torch.dtype = torch.float32,
        module: nn.Module | None = None,
        int8: bool = False,
        device=None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg_name = cfg_name
        self.layer_index = layer_index
        self.spatial_encoding = spatial_encoding
        self.image_size = image_size
        self.transform = transform
        self.dtype = dtype
        if module is not None:
            if params is not None:
                module.load_state_dict(params)
            model = module
        else:
            model = vgg_lib.VGGConvFeatures(cfg_name, layer_index, int8=int8)
            if params is None:
                logger.warning(
                    "DeepConvFeature: no pretrained params given; using "
                    "deterministic random initialization (seed 0)."
                )
            else:
                model.load_params(params)
        model = model.eval().to(device=self.device, dtype=dtype)
        if dtype != torch.float32:
            model = model.to(memory_format=torch.channels_last)
        self._model = model
        if module is not None:
            probe = self._run_trunk(
                torch.zeros((1, image_size, image_size, 3), dtype=dtype, device=self.device)
            )
            if probe.dim() != 4:
                raise ValueError(
                    "Custom module must return a (B, C, Hf, Wf) feature map, "
                    f"got shape {tuple(probe.shape)}."
                )
            self._fmap_hw = (probe.shape[2], probe.shape[3])
            c = probe.shape[1]
        else:
            self._fmap_hw = None
            c = vgg_lib.conv_out_channels(cfg_name, layer_index)
        self._output_dim = c + 2 if spatial_encoding else c

    def list_conv_layers(self):
        """(index, name, out_channels) for each conv layer."""
        chans = [c for c in vgg_lib.VGG_CFGS[self.cfg_name] if c != "M"]
        return [(i, f"conv{i}", c) for i, c in enumerate(chans)]

    @property
    def model(self) -> nn.Module:
        """The trunk module."""
        return self._model

    @model.setter
    def model(self, value: nn.Module):
        """Swap the backbone, as constructing with ``module=value`` does."""
        if not isinstance(value, nn.Module):
            raise ValueError(f"Assign an nn.Module, not {type(value)}.")
        self.__init__(
            cfg_name=self.cfg_name, layer_index=self.layer_index,
            spatial_encoding=self.spatial_encoding, image_size=self.image_size,
            transform=self.transform, dtype=self.dtype, module=value,
            device=self.device,
        )

    @property
    def output_dim(self) -> int:
        return self._output_dim

    @property
    def descriptor_budget(self) -> int | None:
        # Feature-map locations are fixed by the static input size.
        if self._fmap_hw is not None:
            return self._fmap_hw[0] * self._fmap_hw[1]
        n_pools_before = 0
        target = self.layer_index % vgg_lib.num_conv_layers(self.cfg_name)
        conv_i = 0
        for item in vgg_lib.VGG_CFGS[self.cfg_name]:
            if item == "M":
                n_pools_before += 1
            else:
                if conv_i == target:
                    break
                conv_i += 1
        hf = self.image_size // (2**n_pools_before)
        return hf * hf

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """uint8/float ``(B, H, W, 3)`` -> ``(B, S, S, 3)`` in [0, 1], resized
        only when the size differs.

        Each image is resized at its own shape: the JAX package's padding
        buckets exist to bound compiled shapes, which eager PyTorch does not
        have, and it documents its bucketed resize as numerically this one.
        """
        x = images.to(torch.float32) / 255.0
        if x.shape[1] != self.image_size or x.shape[2] != self.image_size:
            x = masked_linear_resize(x, self.image_size)
        return x.to(self.dtype)

    def _run_trunk(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed ``(B, S, S, 3)`` -> the trunk's ``(B, C, Hf, Wf)``."""
        inp = x.to(self.dtype).permute(0, 3, 1, 2)  # channels-last strides
        if self.dtype == torch.float32:
            inp = inp.contiguous()
            # cuDNN runs float32 convs in TF32 unless told otherwise.
            flags = torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
        else:
            flags = contextlib.nullcontext()
        with torch.inference_mode(), flags:
            return self._model(inp)

    def _forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed ``(B, S, S, 3)`` -> ``(B, Hf*Wf, D)`` descriptors."""
        fmap = self._run_trunk(x)
        b, c, hf, wf = fmap.shape
        desc = fmap.permute(0, 2, 3, 1).reshape(b, hf * wf, c)
        if self.spatial_encoding:
            ys = torch.arange(hf, dtype=self.dtype, device=fmap.device) / hf
            xs = torch.arange(wf, dtype=self.dtype, device=fmap.device) / wf
            coords = torch.stack(
                [xs[None, :].expand(hf, wf), ys[:, None].expand(hf, wf)], dim=-1
            ).reshape(1, hf * wf, 2)
            desc = torch.cat([desc, coords.expand(b, hf * wf, 2)], dim=-1)
        return desc

    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        """Raw ``(B, H, W, 3)`` on the device -> ``(B, Hf*Wf, D)``."""
        x = self.transform(images) if self.transform else self._preprocess(images)
        return self._forward_features(x)

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array)).to(self.device)

    @_check_output_shape
    def __call__(self, image: np.ndarray) -> np.ndarray:
        super().__call__(image)
        desc = self._forward(self._to_device(image)[None])
        return desc[0].to(torch.float32).cpu().numpy()

    def extract_batch(self, images):
        """``(desc (B, N, D), mask (B, N))`` for a batch or list of images.

        A uniform batch runs as one device batch, a ragged list is resized
        image by image and then runs as one. More than
        ``PYVISIM_DEEP_DEVICE_BATCH`` (default 128) images run in chunks of
        that size, gathered on the host as numpy, so an unbounded gallery
        pins no device memory.
        """
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        if not isinstance(images, np.ndarray):
            images = list(images)
        cap = int(os.environ.get("PYVISIM_DEEP_DEVICE_BATCH", "128"))
        n = len(images)
        if n > cap:
            parts = [self.extract_batch(images[i : i + cap]) for i in range(0, n, cap)]
            return (
                np.concatenate([p[0].to(torch.float32).cpu().numpy() for p in parts]),
                np.concatenate([p[1].cpu().numpy() for p in parts]),
            )
        if isinstance(images, np.ndarray) and images.ndim == 4:
            desc = self._forward(self._to_device(images))
        elif len({np.asarray(i).shape for i in images}) == 1:
            desc = self._forward(self._to_device(np.stack([np.asarray(i) for i in images])))
        else:
            prep = self.transform or self._preprocess
            pre = [prep(self._to_device(i)[None]) for i in images]
            desc = self._forward_features(torch.cat(pre))
        mask = torch.ones(desc.shape[:2], dtype=torch.float32, device=desc.device)
        return desc, mask

    def __repr__(self):
        return (
            f"DeepConvFeature(cfg={self.cfg_name}, layer_index={self.layer_index}, "
            f"spatial_encoding={self.spatial_encoding}, output_dim={self.output_dim})"
        )
