"""Sharded Siamese training step over a mesh.

Port of ``pyvisim_tpu/parallel/train.py``. JAX jits the whole step with
the images and labels sharded over ``data`` and the head's ``Dense``
kernels sharded column-wise over ``model``, and XLA inserts the
collectives. Here each rank states them:

* **Data parallelism.** Each rank of ``data`` embeds its block of the
  batch. The loss is the loss of the global batch, since every loss
  compares rows across it: each rank gathers the others' embeddings
  (detached) around its own (live) ones, so its backward pass gives the
  gradient through its own rows, and the parameter gradients are summed
  over ``data``. A parameter the loss reads directly (``class_weights``)
  is live on the first ``data`` rank only, so the sum counts it once.
* **Tensor parallelism.** ``fc1.weight`` and ``fc2.weight`` (JAX's Dense
  kernels, whose output columns are these output rows) are split by rows
  over ``model``; everything else, biases included, is replicated. Each
  layer's input and bias enter the split as identities whose backward sums
  over ``model``; each rank adds its slice of the bias, and the output is
  gathered over ``model`` (backward: this rank's columns).

The optimizer's state follows its parameter's shard.
"""
from __future__ import annotations

import inspect

import torch
from torch.func import functional_call

from .._config import full_f32
from ..models.siamese import (SiameseEmbedder, TrainState, adamw, create_train_state,
                              embedding_loss)
from ._collectives import all_gather, all_reduce
from .mesh import NamedSharding, P, axis_index, axis_names, axis_size, data_sharding, mesh_device

__all__ = ["make_sharded_trainer", "shard_train_state"]

_SPLIT = ("fc1", "fc2")


def _param_spec(name: str, leaf: torch.Tensor) -> P:
    """Partition rule: the head's dense weights split by output rows over
    'model'; the conv trunk and every other parameter replicated."""
    if name.split(".")[0] in _SPLIT and leaf.ndim == 2:
        return P("model", None)
    return P()


class _CopyToModel(torch.autograd.Function):
    """Identity; the gradient is summed over 'model' (each rank's slice of
    the layer contributes its part)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, "model"), None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' column blocks along the last dim; the gradient is this
    rank's block (every rank computes the same loss from the gathered
    tensor)."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.width = mesh, y.shape[-1]
        return all_gather(y, mesh, "model", dim=y.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        start = axis_index(ctx.mesh, "model") * ctx.width
        return grad[..., start : start + ctx.width].contiguous(), None


class _ModelParallelEmbedder(SiameseEmbedder):
    """A :class:`SiameseEmbedder` whose head runs on weights split by rows
    over the mesh's 'model' axis; each rank adds its slice of the
    (replicated) bias, whose gradient is summed over 'model' like the
    input's."""

    mesh = None

    def _dense(self, x, layer):
        rows = layer.weight.shape[0]
        start = axis_index(self.mesh, "model") * rows
        bias = _CopyToModel.apply(self._cast(layer.bias), self.mesh)[start : start + rows]
        x = _CopyToModel.apply(x, self.mesh)
        y = torch.nn.functional.linear(x, self._cast(layer.weight), bias)
        return _GatherFromModel.apply(y, self.mesh)


def _optimizer_like(opt: torch.optim.Optimizer, params: list) -> torch.optim.Optimizer:
    """A new optimizer of ``opt``'s class and settings over ``params``."""
    accepted = inspect.signature(type(opt).__init__).parameters
    return type(opt)(params, **{k: v for k, v in opt.defaults.items() if k in accepted})


def _map_state(state: TrainState, fn) -> tuple[dict, dict]:
    """``fn(name, tensor)`` applied to every parameter and to each of its
    optimizer-state tensors of the parameter's shape; returns the new
    parameters and optimizer state dict."""
    opt = state.opt_state
    order = opt.param_groups[0]["params"]
    names = list(state.params)
    if len(opt.param_groups) != 1 or [id(p) for p in order] != [id(state.params[n])
                                                               for n in names]:
        raise ValueError("the state's optimizer must hold its parameters in one group, "
                         "in the order of state.params")
    sd = opt.state_dict()
    for i, name in enumerate(names):
        shape = state.params[name].shape
        if i in sd["state"]:
            sd["state"][i] = {k: fn(name, v) if k != "step" and torch.is_tensor(v)
                              and v.shape == shape else v for k, v in sd["state"][i].items()}
    with torch.no_grad():
        params = {n: fn(n, p.detach()).clone().requires_grad_() for n, p in state.params.items()}
    return params, sd


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """Place a global TrainState on the mesh: each rank keeps its block of
    the parameters that split over 'model' (and of their optimizer state)
    and a copy of the rest, on its device. A state already on this mesh is
    returned as it is."""
    if state.shardings is not None:
        if all(s.mesh is mesh for s in state.shardings.values()):
            return state
        raise ValueError("the state is sharded over another mesh")
    has_model = "model" in axis_names(mesh)
    shardings = {name: NamedSharding(mesh, _param_spec(name, p) if has_model else P())
                 for name, p in state.params.items()}
    dev = mesh_device(mesh)
    params, sd = _map_state(state, lambda name, t: shardings[name].shard(t.to(dev)))
    opt = _optimizer_like(state.opt_state, list(params.values()))
    opt.load_state_dict(sd)
    return TrainState(params=params, opt_state=opt, step=state.step, shardings=shardings)


def _gather(sharding: NamedSharding, t: torch.Tensor) -> torch.Tensor:
    for dim, axis in enumerate(sharding.spec):
        if axis is not None:
            t = all_gather(t, sharding.mesh, axis, dim=dim)
    return t


def gathered_state(state: TrainState) -> tuple[dict, dict]:
    """The global parameters and optimizer state dict of a state on a mesh
    (a collective: every rank calls it)."""
    return _map_state(state, lambda name, t: _gather(state.shardings[name], t))


def _sharded_step(model, optimizer, mesh, loss: str, **loss_kwargs):
    opt_cls = getattr(optimizer, "func", optimizer)
    if loss not in ("nt_xent", "arcface", "cosface", "triplet"):
        raise ValueError(f"Unknown loss: {loss}")

    def step(state: TrainState, images, labels):
        if type(state.opt_state) is not opt_cls:
            raise TypeError(f"the state's optimizer is a {type(state.opt_state).__name__}, "
                            f"not the {opt_cls.__name__} this step was built for")
        dev = mesh_device(mesh)
        images = torch.as_tensor(images).to(device=dev, dtype=torch.float32)
        labels = torch.as_tensor(labels).to(dev)
        n_data, rank = axis_size(mesh, "data"), axis_index(mesh, "data")
        if images.shape[0] % n_data:
            raise ValueError(f"batch of {images.shape[0]} does not divide over {n_data} "
                             "ranks of 'data'")
        block = images.shape[0] // n_data
        state.opt_state.zero_grad(set_to_none=True)
        with full_f32():
            emb = functional_call(model, state.params,
                                  (data_sharding(mesh, 4).shard(images),))
            others = all_gather(emb.detach(), mesh, "data")
            glob = torch.cat([others[: rank * block], emb, others[(rank + 1) * block :]])
            cw = state.params.get("class_weights")
            if cw is not None and rank != 0:
                cw = cw.detach()
            lval = embedding_loss(loss, glob, labels, cw, **loss_kwargs)
            lval.backward()
        params = list(state.params.values())
        grads = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                           for p in params])
        grads = all_reduce(grads, mesh, "data")
        start = 0
        for p in params:
            p.grad = grads[start : start + p.numel()].view_as(p)
            start += p.numel()
        state.opt_state.step()
        state.step += 1
        return state, lval.detach()

    return step


def make_sharded_trainer(
    mesh,
    *,
    cfg_name: str = "vgg11",
    embed_dim: int = 128,
    trunk_convs: int | None = None,
    image_size: int = 64,
    learning_rate: float = 1e-3,
    loss: str = "nt_xent",
    seed: int = 0,
    n_classes: int | None = None,
    **loss_kwargs,
):
    """Build ``(model, sharded TrainState, step_fn)``.

    ``step_fn(state, images, labels) -> (state, loss)`` takes the global
    batch, images ``(B, S, S, 3)`` float in [0, 1] with B divisible by the
    'data' axis, on every rank, and returns the global batch's loss; the
    state is updated in place. ``image_size`` is kept from the JAX
    signature, where it shapes the initialising input; torch builds the
    parameters without one.
    """
    del image_size
    if "model" in axis_names(mesh):
        model = _ModelParallelEmbedder(cfg_name=cfg_name, embed_dim=embed_dim,
                                       trunk_convs=trunk_convs, n_classes=n_classes)
        model.mesh = mesh
    else:
        model = SiameseEmbedder(cfg_name=cfg_name, embed_dim=embed_dim,
                                trunk_convs=trunk_convs, n_classes=n_classes)
    optimizer = adamw(learning_rate)
    state = create_train_state(model, optimizer, seed=seed, device=mesh_device(mesh))
    state = shard_train_state(state, mesh)
    return model, state, _sharded_step(model, optimizer, mesh, loss, **loss_kwargs)
