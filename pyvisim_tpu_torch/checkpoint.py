"""Checkpoint and resume of the Siamese trainer's state.

Port of ``pyvisim_tpu/checkpoint.py`` with ``torch.save`` in place of
Orbax, in the same layout: one checkpoint per step under
``directory/step_%08d``, here a directory holding ``train_state.pt``. A
restore continues training: the step count, the parameters and the
optimizer's state (its moments and step) come back bit for bit.

Orbax checkpoints of the JAX trainer are not read: a model trained in JAX
crosses over through ``models.siamese.params_from_jax`` on its parameters
as numpy arrays.
"""
from __future__ import annotations

import pathlib
from typing import Any

import torch

from ._config import get_logger

logger = get_logger("checkpoint")

__all__ = ["save_train_state", "restore_train_state", "latest_step"]

_FILE = "train_state.pt"


def _step_dir(directory: str, step: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"step_{step:08d}"


def save_train_state(directory: str, state: Any, step: int | None = None) -> str:
    """Save a ``models.siamese.TrainState`` under ``directory/step_<n>``
    (``n`` is ``state.step`` unless given) and return that path.

    A state on a mesh (``parallel.shard_train_state``) is saved as the
    global state: every rank calls this, the shards are gathered, the
    world's rank 0 writes them, and all ranks wait for the file."""
    if step is None:
        step = int(state.step)
    path = _step_dir(directory, step)
    if getattr(state, "shardings", None) is None:
        params, opt_state, writer = ({k: v.detach() for k, v in state.params.items()},
                                     state.opt_state.state_dict(), True)
    else:
        import torch.distributed as dist

        from .parallel.train import gathered_state

        params, opt_state = gathered_state(state)
        writer = dist.get_rank() == 0
    if writer:
        path.mkdir(parents=True, exist_ok=True)
        torch.save({"params": params, "opt_state": opt_state, "step": int(state.step)},
                   path / _FILE)
        logger.info("checkpoint saved: %s", path)
    if getattr(state, "shardings", None) is not None:
        from .parallel._collectives import barrier

        barrier()
    return str(path)


def latest_step(directory: str) -> int | None:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*") if p.is_dir())
    return steps[-1] if steps else None


def restore_train_state(directory: str, target: Any, step: int | None = None) -> Any:
    """Restore the latest (or a given) checkpoint into ``target``, a
    ``TrainState`` of the same model and optimizer (e.g. from
    ``create_train_state``), in place; returns it. The file is read on the
    host; the optimizer moves its moments to its parameters' devices and
    keeps its step counts where its own ``load_state_dict`` puts them.

    A ``target`` on a mesh gives a new global state on its device instead
    (``target`` is left as it is): ``parallel.shard_train_state`` places
    it on the mesh again, as in the JAX package."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {directory}")
    saved = torch.load(_step_dir(directory, step) / _FILE, map_location="cpu",
                       weights_only=True)
    if set(saved["params"]) != set(target.params):
        raise ValueError("the checkpoint's parameters are not the target's: "
                         f"{sorted(set(saved['params']) ^ set(target.params))}")
    if getattr(target, "shardings", None) is not None:
        from .parallel.train import _optimizer_like

        dev = next(iter(target.params.values())).device
        params = {n: v.to(dev).requires_grad_() for n, v in saved["params"].items()}
        opt = _optimizer_like(target.opt_state, list(params.values()))
        opt.load_state_dict(saved["opt_state"])
        return type(target)(params=params, opt_state=opt, step=saved["step"])
    with torch.no_grad():
        for name, value in saved["params"].items():
            target.params[name].copy_(value)
    target.opt_state.load_state_dict(saved["opt_state"])
    target.step = saved["step"]
    return target
