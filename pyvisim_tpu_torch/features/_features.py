"""Feature extractors: SIFT, RootSIFT, Lambda, DeepConvFeature.

Port of ``pyvisim_tpu/features/_features.py``. ``SIFT``/``RootSIFT`` run
the batched detect-and-describe of ``ops/sift.py`` with a fixed keypoint
budget and masks (``backend="torch"``), or OpenCV's ``detectAndCompute``
image by image on the host (``backend="opencv"``, the JAX package's golden
route). ``DeepConvFeature`` is a
VGG trunk (``models/vgg.py``), or a custom module such as a ResNet trunk
(``models/resnet.py``), whose conv map is flattened into descriptors, with
a batched device path. Given ``mesh=`` (a ``parallel.make_mesh`` mesh with
a 'data' axis), ``SIFT``/``RootSIFT`` and ``DeepConvFeature`` split each
batch over the ranks of 'data' and gather the descriptors; their
``extract_block`` keeps each rank's block where it is, for an encoder on
the same mesh.
"""
from __future__ import annotations

import contextlib
import os
from functools import wraps
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from .. import profiling
from .._base_classes import FeatureExtractorBase
from .._config import get_logger, resolve_device
from ..io._staging import upload
from ..models import vgg as vgg_lib
from ..models.quant import QuantConv
from ..ops import sift as sift_ops
from ..ops.resize import masked_linear_resize

logger = get_logger("features")

__all__ = ["SIFT", "RootSIFT", "Lambda", "DeepConvFeature", "FeatureExtractorBase"]


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


_to_gray_u8 = sift_ops._to_gray_u8


def _deep_device_batch() -> int:
    return int(os.environ.get("PYVISIM_DEEP_DEVICE_BATCH", "128"))


def _extractor_device(device, mesh) -> torch.device:
    """An extractor's device: the one given, else the mesh's, else CUDA."""
    if device is None and mesh is not None:
        from ..parallel.mesh import mesh_device

        return mesh_device(mesh)
    return resolve_device(device)


class SIFT(FeatureExtractorBase):
    """Scale-Invariant Feature Transform extractor, 128-D descriptors.

    :param backend: "torch" runs the batched pipeline of ``ops/sift.py``
        on ``device`` with a static per-image keypoint budget; "opencv"
        runs ``cv2.SIFT.create().detectAndCompute`` per image on the host,
        with no budget (the JAX package's golden route).
    :param max_keypoints: static keypoint budget N_max of the torch backend.
    :param process_size: static letterbox resolution of the torch backend.
    :param device: where SIFT runs (the torch backend) and where encoders
        built on this extractor run; None means CUDA (the mesh's device
        with ``mesh``).
    :param mesh: optional mesh with a 'data' axis: ``extract_batch`` of the
        torch backend runs ``parallel.sharded_sift_batch``, each rank
        describing its block of the images.
    """

    def __init__(
        self,
        backend: str = "torch",
        max_keypoints: int = 2048,
        process_size: int = 512,
        device=None,
        mesh=None,
    ):
        super().__init__()
        if backend not in ("torch", "opencv"):
            raise ValueError(f"Unknown SIFT backend: {backend!r}")
        with profiling.span("init"):
            self.mesh = mesh
            self.device = _extractor_device(device, mesh)
            self._output_dim = 128
            self.backend = backend
            self.max_keypoints = max_keypoints
            self.process_size = process_size
            self._root = False  # RootSIFT flips this

    @property
    def output_dim(self) -> int:
        return self._output_dim

    @property
    def descriptor_budget(self) -> int | None:
        return self.max_keypoints if self.backend == "torch" else None

    def _opencv_descriptors(self, image: np.ndarray) -> np.ndarray | None:
        import cv2

        _, descriptors = cv2.SIFT.create().detectAndCompute(image.astype(np.uint8), None)
        if descriptors is not None and self._root:
            descriptors = np.sqrt(descriptors / (descriptors.sum(axis=1, keepdims=True) + 1e-7))
        return descriptors

    @property
    def _sift_cfg(self):
        return sift_ops.SiftConfig(max_keypoints=self.max_keypoints,
                                   process_size=self.process_size)

    @_check_output_shape
    def __call__(self, image: np.ndarray) -> np.ndarray:
        super().__call__(image)
        if self.backend == "opencv":
            return self._opencv_descriptors(image)
        gray = _to_gray_u8(image).astype(np.float32) / 255.0
        desc, mask = sift_ops.sift_single(
            gray, max_keypoints=self.max_keypoints, root_sift=self._root, cfg=self._sift_cfg,
            run_on=self.device,
        )
        return desc[mask > 0.5]

    def _grays(self, images) -> list[np.ndarray]:
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        with profiling.span("ingest.gray"):
            return [_to_gray_u8(np.asarray(img)) for img in images]

    def _raw(self, images):
        """The images as ``ops.sift`` takes them: a batch whose images are
        all uint8 as it is (a batch array stays one array), to be turned
        gray and letterboxed on the device; any other batch turned into
        uint8 grays here (``_grays``), as the extractor always did."""
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        if not (isinstance(images, np.ndarray) and images.dtype == np.uint8):
            images = [np.asarray(img) for img in images]
            if not all(img.dtype == np.uint8 for img in images):
                return self._grays(images)
        return images

    def extract_batch(self, images):
        """``(desc (B, N, 128), mask (B, N))`` as numpy arrays, in device
        calls of ``PYVISIM_SIFT_DEVICE_BATCH`` (default 16) images (the
        opencv backend: image by image, padded to the most descriptors).

        uint8 images (gray, RGB or RGBA) go to the device raw and are
        turned gray and letterboxed there (``ops/sift.py:sift_descriptors``);
        a batch holding any other dtype is turned gray on the host first.
        On a mesh every image is turned gray on the host."""
        if self.backend == "opencv":
            return super().extract_batch(images)
        if self.mesh is not None:
            from ..parallel import sharded_sift_batch

            return sharded_sift_batch(self._grays(images), self.mesh, cfg=self._sift_cfg,
                                      root_sift=self._root)
        return sift_ops.sift_batch(
            self._raw(images), max_keypoints=self.max_keypoints, root_sift=self._root,
            cfg=self._sift_cfg, run_on=self.device,
        )

    def extract_block(self, images):
        """``(desc, mask, n)``: this rank's block of the batch on the mesh,
        described by this rank alone and left on the device, and the
        batch's size ``n``. The block is rows ``[r*s, (r+1)*s)`` of the
        batch padded with blank images to ``s`` per rank of 'data', so an
        encoder on the same mesh encodes the descriptors where they are and
        gathers the encodings alone."""
        from ..parallel.sharded import _list_block, _padded_rows

        if self.backend == "opencv":
            desc, mask = self.extract_batch(images)
            (desc, mask), n = _padded_rows(self.mesh, torch.as_tensor(desc),
                                           torch.as_tensor(mask))
            return desc, mask, n
        mine, n = _list_block(self._grays(images), self.mesh)
        desc, mask = sift_ops.sift_batch(
            mine, max_keypoints=self.max_keypoints, root_sift=self._root,
            cfg=self._sift_cfg, device=True, run_on=self.device,
        )
        return desc, mask, n

    def extract_batch_device(self, images):
        """As ``extract_batch``, but the results stay on the device as
        tensors (f32, root-SIFT applied there), so an encoder that follows
        on the device needs no copies. uint8 images are uploaded raw and
        turned gray and letterboxed on the device, as in ``extract_batch``.
        More than 16 device calls' worth of images take ``extract_batch``,
        so a gallery pins no device memory; the opencv backend and a mesh
        always do."""
        if self.backend == "opencv" or self.mesh is not None:
            return self.extract_batch(images)
        if not isinstance(images, np.ndarray):
            images = list(images)
        cap = 16 * int(os.environ.get("PYVISIM_SIFT_DEVICE_BATCH", "16"))
        if len(images) > cap:
            return self.extract_batch(images)
        return sift_ops.sift_batch(
            self._raw(images), max_keypoints=self.max_keypoints, root_sift=self._root,
            cfg=self._sift_cfg, device=True, run_on=self.device,
        )

    def __repr__(self):
        return f"{type(self).__name__}(output_dim={self.output_dim}, backend={self.backend!r})"


class RootSIFT(SIFT):
    """SIFT with the Hellinger kernel map: L1-normalise (+1e-7), then the
    square root, applied on the device."""

    def __init__(
        self,
        backend: str = "torch",
        max_keypoints: int = 2048,
        process_size: int = 512,
        device=None,
        mesh=None,
    ):
        super().__init__(backend=backend, max_keypoints=max_keypoints,
                         process_size=process_size, device=device, mesh=mesh)
        self._root = True


class Lambda(FeatureExtractorBase):
    """Wraps any user callable ``image -> (N, output_dim)`` array."""

    def __init__(self, func: Callable, output_dim: int):
        super().__init__()
        if not callable(func):
            raise ValueError(
                f"Argument func must be a callable object, got {type(func)} instead"
            )
        self._output_dim = output_dim
        self.func = func

    @property
    def output_dim(self) -> int:
        return self._output_dim

    @_check_output_shape
    def __call__(self, image: np.ndarray) -> np.ndarray:
        super().__call__(image)
        return self.func(image)

    def __repr__(self):
        return f"Lambda(output_dim={self.output_dim})"


class DeepConvFeature(FeatureExtractorBase):
    """Deep feature extractor over a VGG trunk, or a custom conv or token
    trunk (``module``).

    Flattens the trunk's map (the chosen VGG conv layer's post-ReLU map, or
    the module's ``(B, C, Hf, Wf)`` output) to ``(Hf*Wf, C)`` descriptors
    in (h, w) row-major order and optionally appends the
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
        ``(B, C, Hf, Wf)`` map, used in place of the VGG trunk: a conv trunk
        such as ``models.resnet.ResNetTrunk`` (float or int8), or a token
        trunk that returns its patch tokens as that grid, such as
        ``models.vit.ViTTrunk`` (a facet of one block, the CLS token
        dropped); ``params``, if given, is loaded into it. A module that
        holds a ``QuantConv`` runs channels-last in every dtype, as the int8
        VGG trunk does.
    :param int8: route the middle VGG convs through int8 (dynamic symmetric
        quantisation, per-image activation scales, per-channel weight
        scales; trunk-encoding cosine vs float32 > 0.999), and each conv
        followed by a pool through a fused conv + ReLU + pool kernel; see
        ``models/vgg.py``. Ignored for custom modules.
    :param device: where the trunk runs; None means CUDA (the mesh's device
        with ``mesh``).
    :param mesh: optional mesh with a 'data' axis: each rank runs the trunk
        on its block of a batch (padded to divide), and the descriptors are
        gathered.
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
        mesh=None,
    ):
        super().__init__()
        with profiling.span("init"):
            self.mesh = mesh
            self.device = _extractor_device(device, mesh)
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
            # An int8 trunk runs channels-last in every dtype: its kernels read NHWC.
            self._channels_last = dtype != torch.float32 or any(
                isinstance(m, QuantConv) for m in model.modules())
            if module is not None:
                probe = self._run_trunk(
                    torch.zeros((1, image_size, image_size, 3), dtype=dtype, device=self.device)
                )
                if probe.dim() != 4:
                    raise ValueError(
                        "Custom module must return a (B, C, Hf, Wf) feature map (a "
                        "token trunk: its patch tokens as that grid), "
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
            device=self.device, mesh=self.mesh,
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
        if not self._channels_last:
            inp = inp.contiguous()
        if self.dtype == torch.float32:
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

    def _run_forward(self, batch: torch.Tensor, preprocessed: bool) -> torch.Tensor:
        """A uniform batch through ``_forward`` (raw) or ``_forward_features``
        (preprocessed); on a mesh, each rank runs its block of the batch
        padded to divide over 'data', and the blocks are gathered."""
        fn = self._forward_features if preprocessed else self._forward
        with profiling.span("features"):
            if self.mesh is None:
                return fn(batch)
            from ..parallel._collectives import all_gather
            from ..parallel.sharded import _padded_rows

            (block,), b = _padded_rows(self.mesh, batch)
            return all_gather(fn(block), self.mesh, "data")[:b]

    def _to_device(self, array) -> torch.Tensor:
        with profiling.span("ingest.upload"):
            host = np.asarray(array)
            profiling.count("h2d_bytes", host.nbytes)
            return upload(host, self.device)

    @_check_output_shape
    def __call__(self, image: np.ndarray) -> np.ndarray:
        super().__call__(image)
        desc = self._forward(self._to_device(image)[None])
        return desc[0].to(torch.float32).cpu().numpy()

    def _device_batch(self, images) -> tuple[torch.Tensor, bool]:
        """Images as one device batch and whether it is preprocessed: a
        tensor batch (e.g. from io.prefetch_to_device) or a uniform batch
        as it is, a ragged list resized image by image."""
        if torch.is_tensor(images):
            return (images[None] if images.ndim == 3 else images).to(self.device), False
        if isinstance(images, np.ndarray) and images.ndim == 4:
            return self._to_device(images), False
        if len({np.asarray(i).shape for i in images}) == 1:
            return self._to_device(np.stack([np.asarray(i) for i in images])), False
        prep = self.transform or self._preprocess
        return torch.cat([prep(self._to_device(i)[None]) for i in images]), True

    def extract_batch(self, images):
        """``(desc (B, N, D), mask (B, N))`` for a batch or list of images,
        or a ``(B, H, W, 3)`` tensor.

        A uniform batch runs as one device batch, a ragged list is resized
        image by image and then runs as one. More than
        ``PYVISIM_DEEP_DEVICE_BATCH`` (default 128) images in a list or
        array run in chunks of that size, gathered on the host as numpy, so
        an unbounded gallery pins no device memory.
        """
        if not torch.is_tensor(images):
            if isinstance(images, np.ndarray) and images.ndim == 3:
                images = [images]
            if not isinstance(images, np.ndarray):
                images = list(images)
            cap = _deep_device_batch()
            n = len(images)
            if n > cap:
                parts = [self.extract_batch(images[i : i + cap]) for i in range(0, n, cap)]
                return (
                    np.concatenate([p[0].to(torch.float32).cpu().numpy() for p in parts]),
                    np.concatenate([p[1].cpu().numpy() for p in parts]),
                )
        desc = self._run_forward(*self._device_batch(images))
        return desc, torch.ones(desc.shape[:2], dtype=torch.float32, device=desc.device)

    def extract_block(self, images):
        """``(desc, mask, n)``: this rank's block of ``extract_batch`` on the
        mesh, left on the device, and the batch's size ``n``. Each rank runs
        the trunk on its block of the padded batch only (in chunks of
        ``PYVISIM_DEEP_DEVICE_BATCH``), so an encoder on the same mesh
        encodes the descriptors where they are and gathers the encodings
        alone."""
        from ..parallel.sharded import _padded_rows

        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        if not isinstance(images, (np.ndarray, torch.Tensor)):
            images = list(images)
        batch, preprocessed = self._device_batch(images)
        (block,), n = _padded_rows(self.mesh, batch)
        fn = self._forward_features if preprocessed else self._forward
        cap = _deep_device_batch()
        desc = torch.cat([fn(block[i : i + cap]) for i in range(0, len(block), cap)])
        return desc, torch.ones(desc.shape[:2], dtype=torch.float32, device=desc.device), n

    def __repr__(self):
        return (
            f"DeepConvFeature(cfg={self.cfg_name}, layer_index={self.layer_index}, "
            f"spatial_encoding={self.spatial_encoding}, output_dim={self.output_dim})"
        )
