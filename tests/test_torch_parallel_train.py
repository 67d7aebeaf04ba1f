"""The port's sharded Siamese trainer (``parallel.make_sharded_trainer``,
``shard_train_state``) and the sharded checkpoint resume, in a gloo world
of four CPU ranks: on a ``data`` = 4 mesh (data parallel) and a 2 x 2
``data`` x ``model`` mesh (each model rank holding half of ``fc1``'s and
``fc2``'s rows), against the single-process trainer and against the JAX
package's sharded trainer on a mesh of the same shape.

The ranks import this file for its ``job_*`` functions; it imports JAX only
inside fixtures.

Tolerances: a step's loss is the global batch's, so it equals the
single-process loss to float32 rounding (rel 1e-5), and the gradients
summed over 'data' to 1e-4 of their largest entry (the ranks' partial
gradients are added in another order than one backward pass adds them).
Adam's first update is about lr * sign(g), so a near-zero gradient entry
whose sum rounds otherwise can move its parameter by up to 2 * lr:
parameters are held within 2 * lr * steps, and to 1e-6 on all but 1 % of
entries. The losses of three steps against JAX's: rel 1e-4.
"""
import numpy as np
import pytest
import torch

from pyvisim_tpu_torch.parallel.local import LocalWorld

N_RANKS = 4
LR = 1e-3
MODEL = {"cfg_name": "vgg11", "embed_dim": 16, "trunk_convs": 1}
SHAPES = {"dp": (("data",), None), "tp": (("data", "model"), (2, 2))}
_MESHES = {}


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------
def _mesh(kind):
    from pyvisim_tpu_torch.parallel import make_mesh

    if kind not in _MESHES:
        names, shape = SHAPES[kind]
        _MESHES[kind] = make_mesh(N_RANKS, names, shape, device_type="cpu")
    return _MESHES[kind]


def _trainer(kind, loss, n_classes, init):
    """The sharded trainer; with ``init`` (global numpy params) its state
    starts from those parameters."""
    from pyvisim_tpu_torch.models.siamese import SiameseEmbedder, adamw, create_train_state
    from pyvisim_tpu_torch.parallel import make_sharded_trainer, shard_train_state

    kw = {"margin": 0.3} if loss == "arcface" else {}
    mesh = _mesh(kind)
    model, state, step = make_sharded_trainer(mesh, image_size=16, loss=loss,
                                              n_classes=n_classes, **MODEL, **kw)
    if init is not None:
        state = create_train_state(SiameseEmbedder(n_classes=n_classes, **MODEL), adamw(LR),
                                   device="cpu")
        with torch.no_grad():
            for name, value in init.items():
                state.params[name].copy_(torch.from_numpy(value))
        state = shard_train_state(state, mesh)
    return mesh, state, step


def job_train(kind, loss, n_classes, init, images, labels, steps):
    """Losses of ``steps`` steps, then the global parameters and the last
    step's summed gradients, and each parameter's local shape."""
    from pyvisim_tpu_torch.parallel.train import _gather, gathered_state

    _, state, step = _trainer(kind, loss, n_classes, init)
    losses = [float(step(state, images, labels)[1]) for _ in range(steps)]
    grads = {n: _gather(state.shardings[n], p.grad).numpy() for n, p in state.params.items()}
    params, _ = gathered_state(state)
    shapes = {n: tuple(p.shape) for n, p in state.params.items()}
    specs = {n: tuple(s.spec) for n, s in state.shardings.items()}
    return (losses, {n: p.detach().numpy() for n, p in params.items()}, grads, shapes, specs,
            int(state.step))


def job_resume(kind, images, labels, directory):
    """One step, save, restore into a fresh trainer, place on the mesh, and
    one more step."""
    from pyvisim_tpu_torch.checkpoint import restore_train_state, save_train_state
    from pyvisim_tpu_torch.parallel import make_sharded_trainer, shard_train_state
    from pyvisim_tpu_torch.parallel.train import gathered_state

    mesh = _mesh(kind)
    _, state, step = make_sharded_trainer(mesh, image_size=16, **MODEL)
    state, _ = step(state, images, labels)
    save_train_state(directory, state)
    _, template, step2 = make_sharded_trainer(mesh, image_size=16, **MODEL)
    restored = shard_train_state(restore_train_state(directory, template), mesh)
    same = all(torch.equal(a, b) for a, b in zip(state.params.values(),
                                                 restored.params.values()))
    same_opt = all(
        torch.equal(a, b) for sa, sb in zip(state.opt_state.state.values(),
                                            restored.opt_state.state.values())
        for a, b in zip(sa.values(), sb.values()))
    restored_step = int(restored.step)
    restored, loss_r = step2(restored, images, labels)
    state, loss_s = step(state, images, labels)
    params_r, _ = gathered_state(restored)
    params_s, _ = gathered_state(state)
    resumed_equal = all(torch.equal(params_r[n], params_s[n]) for n in params_s)
    return (same, same_opt, restored_step, restored.shardings is not None, float(loss_r),
            float(loss_s), int(restored.step), resumed_equal)


# ---------------------------------------------------------------------------
# Test side
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    w = LocalWorld(N_RANKS, "gloo", "cpu", threads=1, timeout_s=120)
    yield w
    w.close()


def run(world, job, *args):
    """``job(*args)`` on every rank; the global results equal on all."""
    out = world.run(job, *args)
    for other in out[1:]:
        assert other[0] == out[0][0]
    return out


def _batch(rng, n, size=16):
    images = rng.random((n, size, size, 3)).astype(np.float32)
    labels = np.asarray([i % 4 for i in range(n)])
    return images, labels


def _single_process(init, loss, n_classes, images, labels, steps):
    """The single-process trainer from the same parameters: its losses, its
    parameters and its last gradients."""
    from pyvisim_tpu_torch.models.siamese import (SiameseEmbedder, adamw, create_train_state,
                                                  train_step)

    model = SiameseEmbedder(n_classes=n_classes, **MODEL)
    state = create_train_state(model, adamw(LR), device="cpu")
    with torch.no_grad():
        for name, value in init.items():
            state.params[name].copy_(torch.from_numpy(value))
    kw = {"margin": 0.3} if loss == "arcface" else {}
    step = train_step(model, adamw(LR), loss=loss, **kw)
    losses = [float(step(state, torch.from_numpy(images), torch.from_numpy(labels))[1])
              for _ in range(steps)]
    return (losses, {n: p.detach().numpy() for n, p in state.params.items()},
            {n: p.grad.numpy() for n, p in state.params.items()})


def _port_init(n_classes, seed=1):
    from pyvisim_tpu_torch.models.siamese import SiameseEmbedder

    model = SiameseEmbedder(n_classes=n_classes, **MODEL,
                            generator=torch.Generator().manual_seed(seed))
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def test_sharded_siamese_train_step(world, rng):
    images, labels = _batch(rng, 16)
    out = run(world, job_train, "dp", "nt_xent", None, None, images, labels, 6)
    losses, _, _, _, _, steps = out[0]
    assert steps == 6
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]  # optimises on a fixed batch


def test_tp_mesh_train_step(world, rng):
    images, labels = _batch(rng, 8)
    out = run(world, job_train, "tp", "nt_xent", None, None, images, labels, 1)
    losses, params, _, shapes, specs, _ = out[0]
    assert np.isfinite(losses).all()
    # the head's dense weights really split over 'model': half the rows each
    for name in ("fc1.weight", "fc2.weight"):
        assert specs[name] == ("model", None)
        assert shapes[name] == (params[name].shape[0] // 2, params[name].shape[1])
    assert specs["fc1.bias"] == () and shapes["fc1.bias"] == params["fc1.bias"].shape
    assert specs["conv0.weight"] == ()


def test_arcface_train_step(world, rng):
    images, labels = _batch(rng, 8)
    losses = run(world, job_train, "dp", "arcface", 4, None, images, labels, 6)[0][0]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("kind", ["dp", "tp"])
@pytest.mark.parametrize("loss", ["nt_xent", "triplet", "arcface"])
def test_sharded_step_equals_the_single_process_step(world, rng, kind, loss):
    """One and two steps from the same parameters: the loss of the global
    batch, the gradients summed over 'data' (and over 'model' inside the
    head) and the updated parameters equal the single-process trainer's on
    the whole batch (tolerances in the module docstring)."""
    n_classes = 4 if loss == "arcface" else None
    init = _port_init(n_classes)
    images, labels = _batch(rng, 8)
    for steps in (1, 2):
        out = run(world, job_train, kind, loss, n_classes, init, images, labels, steps)
        losses, params, grads, _, _, _ = out[0]
        want_losses, want_params, want_grads = _single_process(init, loss, n_classes, images,
                                                               labels, steps)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for name, g in want_grads.items():
            np.testing.assert_allclose(grads[name], g, rtol=0,
                                       atol=1e-4 * max(np.abs(g).max(), 1e-12), err_msg=name)
        for name, p in want_params.items():
            diff = np.abs(params[name] - p)
            assert diff.max() <= 2 * LR * steps * 1.01, name
            assert np.mean(diff > 1e-6) <= 0.01, name


@pytest.fixture(scope="module")
def jax_trainers():
    """JAX's sharded trainers on meshes of the ranks' shapes: initial
    parameters and three steps' losses, per (mesh kind, loss)."""
    import jax

    from pyvisim_tpu import parallel as jpar

    rng = np.random.default_rng(5)
    images, labels = _batch(rng, 8)
    out = {}
    for kind, (names, shape) in SHAPES.items():
        mesh = jpar.make_mesh(N_RANKS, names, shape)
        for loss in ("nt_xent", "arcface"):
            kw = {"n_classes": 4, "margin": 0.3} if loss == "arcface" else {}
            _, state, step = jpar.make_sharded_trainer(mesh, image_size=16, loss=loss,
                                                       learning_rate=LR, **MODEL, **kw)
            params0 = jax.tree_util.tree_map(np.asarray, state.params)
            losses = []
            for _ in range(3):
                state, lval = step(state, images, labels)
                losses.append(float(lval))
            out[kind, loss] = params0, losses
    return images, labels, out


@pytest.mark.parametrize("kind", ["dp", "tp"])
@pytest.mark.parametrize("loss", ["nt_xent", "arcface"])
def test_sharded_trainer_matches_jax(world, jax_trainers, kind, loss):
    """JAX's initial parameters, carried over with ``params_from_jax``:
    three steps' losses within rel 1e-4 of JAX's on a mesh of the same
    shape."""
    from pyvisim_tpu_torch.models.siamese import SiameseEmbedder, params_from_jax

    images, labels, ref = jax_trainers
    params0, want = ref[kind, loss]
    n_classes = 4 if loss == "arcface" else None
    init = {n: t.numpy() for n, t in
            params_from_jax(params0, SiameseEmbedder(n_classes=n_classes, **MODEL)).items()}
    losses = run(world, job_train, kind, loss, n_classes, init, images, labels, 3)[0][0]
    np.testing.assert_allclose(losses, want, rtol=1e-4)


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_sharded_checkpoint_resume(world, rng, tmp_path, kind):
    """Save a sharded TrainState (gathered, written by rank 0), restore it
    into a fresh trainer, place it on the mesh again and go on training:
    parameters and optimizer state come back bit for bit, and the next step
    from both states is equal."""
    images, labels = _batch(rng, 8)
    out = world.run(job_resume, kind, images, labels, str(tmp_path / "ckpt"))
    for same, same_opt, step0, sharded, loss_r, loss_s, step1, resumed_equal in out:
        assert same and same_opt and sharded
        assert step0 == 1 and step1 == 2
        assert np.isfinite(loss_r) and loss_r == loss_s
        assert resumed_equal
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_00000001"]
