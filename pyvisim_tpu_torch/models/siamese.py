"""Siamese embedding network and its trainer.

Port of ``pyvisim_tpu/models/siamese.py``: a VGG conv trunk -> GeM pooling
-> two-layer projection head -> L2-normalised embedding, trained with the
retrieval losses of ``pyvisim_tpu_torch.losses``.

The JAX trainer is functional (Flax ``apply`` on a parameter tree, optax on
its state), and so is this one: :class:`SiameseEmbedder` is the template
that ``torch.func.functional_call`` runs on a :class:`TrainState`'s
parameter dict, and one step function serves any number of states. The
state's optimizer is a ``torch.optim`` optimizer bound to those
parameters; :func:`adamw` and :func:`adam` build it with optax's defaults
(``torch.optim.AdamW`` would otherwise decay by 1e-2, where
``optax.adamw`` decays by 1e-4). A step updates its state in place and
returns it.

Float32 runs the convs on cuDNN and the products on cuBLAS with TF32 off,
as the JAX package computes in full float32. ``dtype=torch.bfloat16``
computes the convs and the head in bf16 with float32 parameters, as Flax's
``dtype`` does; GeM pools in float32, where JAX's type promotion puts it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .._config import full_f32, resolve_device
from ..losses import margin_softmax_loss, nt_xent_loss
from .quant import lecun_normal_
from .vgg import VGG_CFGS

__all__ = [
    "GeMPool",
    "SiameseEmbedder",
    "TrainState",
    "adamw",
    "adam",
    "create_train_state",
    "make_loss_fn",
    "embedding_loss",
    "train_step",
    "embed",
    "params_from_jax",
]


class GeMPool(nn.Module):
    """Generalised-mean pooling over the spatial dims with a learnable
    exponent ``p`` (initially 3): ``mean(max(x, eps) ** p) ** (1 / p)``,
    ``(B, C, H, W) -> (B, C)``, in ``p``'s dtype."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.p = nn.Parameter(torch.tensor(3.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.p.dtype)
        x = torch.maximum(x, x.new_tensor(self.eps)) ** self.p
        return torch.mean(x, dim=(2, 3)) ** (1.0 / self.p)


class SiameseEmbedder(nn.Module):
    """Conv trunk + GeM pooling + 2-layer projection head -> L2-normalised
    embedding; ``(B, H, W, 3)`` in [0, 1] -> ``(B, embed_dim)``.

    :param cfg_name: VGG config of the trunk ("vgg11", "vgg16", "vgg19"):
        3x3 padding-1 convs with ReLU and 2x2 max pools.
    :param embed_dim: output dimensionality.
    :param trunk_convs: number of leading convs of the config to keep (None:
        all); the pools before the first conv left out still run.
    :param n_classes: when set, a learnable ``(n_classes, embed_dim)``
        ``class_weights`` matrix for the margin-softmax losses.
    :param dtype: ``torch.float32`` or ``torch.bfloat16`` (compute dtype;
        the parameters stay float32).
    :param generator: the initialisation draws, as Flax does, lecun-normal
        kernels, zero biases and N(0, 0.01^2) class weights from it (seed 0
        when None).
    """

    def __init__(
        self,
        cfg_name: str = "vgg16",
        embed_dim: int = 128,
        trunk_convs: int | None = None,
        n_classes: int | None = None,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.cfg_name, self.embed_dim = cfg_name, embed_dim
        self.trunk_convs, self.n_classes, self.dtype = trunk_convs, n_classes, dtype
        self._plan: list[Optional[int]] = []  # conv index, or None for a pool
        cin, conv_i = 3, 0
        for item in VGG_CFGS[cfg_name]:
            if item == "M":
                self._plan.append(None)
                continue
            if trunk_convs is not None and conv_i >= trunk_convs:
                break
            setattr(self, f"conv{conv_i}", nn.Conv2d(cin, item, 3, padding=1))
            self._plan.append(conv_i)
            cin, conv_i = item, conv_i + 1
        self.gem = GeMPool()
        self.fc1 = nn.Linear(cin, 2 * embed_dim)
        self.fc2 = nn.Linear(2 * embed_dim, embed_dim)
        if n_classes is not None:
            self.class_weights = nn.Parameter(torch.empty(n_classes, embed_dim))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        lecun_normal_(self, generator)
        self.gem.p.fill_(3.0)
        if self.n_classes is not None:
            self.class_weights.copy_(
                torch.randn(self.class_weights.shape, generator=generator) * 0.01)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    def _dense(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        """One layer of the projection head (the mesh trainer shards it)."""
        return F.linear(x, self._cast(layer.weight), self._cast(layer.bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._cast(x.permute(0, 3, 1, 2))  # channels-last strides
        for conv_i in self._plan:
            if conv_i is None:
                x = F.max_pool2d(x, 2, 2)
                continue
            conv = getattr(self, f"conv{conv_i}")
            x = torch.relu(F.conv2d(x, self._cast(conv.weight), self._cast(conv.bias), padding=1))
        x = self._cast(self.gem(x))
        x = torch.relu(self._dense(x, self.fc1))
        x = self._dense(x, self.fc2)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.maximum(norm, norm.new_tensor(1e-12))


@dataclass
class TrainState:
    """``params``: the embedder's parameters by name (leaf tensors that
    require grad); ``opt_state``: the optimizer bound to them; ``step``: the
    number of steps taken; ``shardings``: for a state on a mesh
    (``parallel.shard_train_state``), each parameter's
    ``parallel.NamedSharding``, else None."""

    params: Dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    step: int = 0
    shardings: Optional[Dict[str, Any]] = None


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Callable:
    """``optax.adamw``'s defaults as a ``torch.optim.AdamW`` factory: ``eps``
    outside the square root, ``weight_decay`` on every parameter."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Callable:
    """``optax.adam``'s defaults as a ``torch.optim.Adam`` factory."""
    return functools.partial(torch.optim.Adam, lr=learning_rate, betas=(b1, b2), eps=eps)


def create_train_state(model: SiameseEmbedder, optimizer: Callable, seed: int = 0,
                       device=None) -> TrainState:
    """A fresh state: the model's parameters drawn from
    ``torch.Generator().manual_seed(seed)`` (the model itself is
    re-initialised), copied to ``device`` (None means CUDA), and
    ``optimizer(params)`` over all of them in one group."""
    device = resolve_device(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    params = {k: v.detach().to(device, copy=True).requires_grad_()
              for k, v in model.named_parameters()}
    return TrainState(params=params, opt_state=optimizer(list(params.values())), step=0)


def make_loss_fn(model: SiameseEmbedder, loss: str = "nt_xent", **loss_kwargs) -> Callable:
    """``loss_fn(params, images (B, H, W, 3) in [0, 1], labels (B,)) -> loss``.
    ``triplet`` mines the hardest positive and negative of each row inside
    the batch (``amax``/``amin`` split the gradient on ties, as JAX's
    reductions do)."""
    if loss not in ("nt_xent", "arcface", "cosface", "triplet"):
        raise ValueError(f"Unknown loss: {loss}")

    def loss_fn(params, images, labels):
        emb = functional_call(model, params, (images,))
        return embedding_loss(loss, emb, labels, params.get("class_weights"), **loss_kwargs)

    return loss_fn


def embedding_loss(loss: str, emb: torch.Tensor, labels, class_weights=None,
                   **loss_kwargs) -> torch.Tensor:
    """The batch loss of embeddings ``emb (B, E)`` with integer ``labels
    (B,)``; ``class_weights`` for the margin-softmax losses."""
    labels = torch.as_tensor(labels, device=emb.device)
    if loss == "nt_xent":
        return nt_xent_loss(emb, labels, **loss_kwargs)
    if loss in ("arcface", "cosface"):
        return margin_softmax_loss(emb, labels, class_weights, kind=loss, **loss_kwargs)
    d = torch.sum((emb[:, None, :] - emb[None, :, :]) ** 2, dim=-1)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=emb.device)
    hardest_pos = torch.amax(torch.where(same & ~eye, d, torch.zeros_like(d)), dim=1)
    hardest_neg = torch.amin(torch.where(~same, d, torch.full_like(d, torch.inf)), dim=1)
    margin = loss_kwargs.get("margin", 0.2)
    gap = hardest_pos - hardest_neg + margin
    return torch.mean(torch.maximum(gap, gap.new_tensor(0.0)))


def train_step(model: SiameseEmbedder, optimizer: Callable, loss: str = "nt_xent",
               **loss_kwargs) -> Callable[[TrainState, Any, Any], tuple[TrainState, torch.Tensor]]:
    """``step(state, images, labels) -> (state, loss)``: the loss and its
    gradients in full float32 (TF32 off), then one update of the state's
    optimizer, which must have been built by ``optimizer`` (the factory
    given to :func:`create_train_state`). Parameters that the loss does not
    reach get zero gradients, so they decay and count steps as under optax.
    The state is updated in place and returned; the loss is a detached
    device scalar."""
    loss_fn = make_loss_fn(model, loss, **loss_kwargs)
    opt_cls = getattr(optimizer, "func", optimizer)

    def step(state: TrainState, images, labels):
        if type(state.opt_state) is not opt_cls:
            raise TypeError(f"the state's optimizer is a {type(state.opt_state).__name__}, "
                            f"not the {opt_cls.__name__} this step was built for")
        state.opt_state.zero_grad(set_to_none=True)
        with full_f32():
            lval = loss_fn(state.params, images, labels)
            lval.backward()
        for p in state.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.opt_state.step()
        state.step += 1
        return state, lval.detach()

    return step


def embed(model: SiameseEmbedder, params: Dict[str, torch.Tensor], images: torch.Tensor
          ) -> torch.Tensor:
    """Embeddings of preprocessed ``(B, H, W, 3)`` images, without autograd,
    in full float32."""
    with torch.no_grad(), full_f32():
        return functional_call(model, params, (images,))


def params_from_jax(params: Dict, model: SiameseEmbedder) -> Dict[str, torch.Tensor]:
    """Convert the JAX embedder's Flax params (numpy arrays, with or without
    the outer ``{"params": ...}``) to ``model``'s parameter names: ``conv{i}``
    kernels HWIO -> OIHW, ``Dense_0``/``Dense_1`` (in, out) -> ``fc1``/``fc2``
    (out, in), ``GeMPool_0/p`` -> ``gem.p``, ``class_weights`` as it is."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, value) -> None:
        out[name] = torch.from_numpy(np.array(value, np.float32, order="C"))

    for name in dict(model.named_parameters()):
        head, _, leaf = name.rpartition(".")
        if head.startswith("conv"):
            src = tree[head]
            put(name, src["kernel"].transpose(3, 2, 0, 1) if leaf == "weight" else src["bias"])
        elif head in ("fc1", "fc2"):
            src = tree[f"Dense_{int(head[2]) - 1}"]
            put(name, np.asarray(src["kernel"]).T if leaf == "weight" else src["bias"])
        elif name == "gem.p":
            put(name, tree["GeMPool_0"]["p"])
        else:
            put(name, tree[name])
    return out
