"""The port's Siamese embedder, trainer, checkpoints and encoder against
the JAX package's, on the same parameters and seed-made batches.

Tolerances: embeddings to 2e-6 (unit vectors; the two stacks sum convs
and products in other orders); losses to rtol 1e-5 and gradients to
2e-4 * max|ref| per tensor (rtol 1e-3 for margin softmax, whose logits are
scaled by 64 and whose arccos amplifies the embeddings' last bits).
Optimizer arithmetic fed the same gradients: parameters to 1e-4 * lr
per step and moments to rtol 1e-6 (``torch.optim`` and optax order the
same operations differently). Post-step parameters of a real step are
not compared: a first Adam step moves each parameter by about
lr * sign(g), so a gradient at the noise floor flips a whole lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyvisim_tpu.encoders import SiameseEncoder as JSiameseEncoder
from pyvisim_tpu.models import siamese as jsiam
from pyvisim_tpu_torch import checkpoint as tckpt
from pyvisim_tpu_torch import neural_networks, profiling
from pyvisim_tpu_torch.encoders import SiameseEncoder
from pyvisim_tpu_torch.models import siamese as tsiam

LOSSES = ("nt_xent", "triplet", "arcface", "cosface")
LABELS = np.array([0, 0, 1, 1, 2, 2, 3, 3])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed=0, b=8, size=32):
    return np.random.default_rng(seed).random((b, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX module, JAX params as numpy, port module, port params) for
    vgg11 at trunk_convs=2 with 4 classes."""
    jm = jsiam.SiameseEmbedder(cfg_name="vgg11", embed_dim=16, trunk_convs=2, n_classes=4)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 32, 32, 3))))
    tm = tsiam.SiameseEmbedder("vgg11", embed_dim=16, trunk_convs=2, n_classes=4)
    tp = {k: v.requires_grad_() for k, v in tsiam.params_from_jax(jp, tm).items()}
    return jm, jp, tm, tp


@pytest.mark.parametrize("trunk_convs", [1, 2])
def test_forward_matches_jax(trunk_convs):
    jm = jsiam.SiameseEmbedder(cfg_name="vgg11", embed_dim=16, trunk_convs=trunk_convs)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                                    jnp.zeros((1, 32, 32, 3))))
    tm = tsiam.SiameseEmbedder("vgg11", embed_dim=16, trunk_convs=trunk_convs)
    x = _images(seed=trunk_convs)
    want = np.asarray(jax.jit(jm.apply)(jp, x))
    got = tsiam.embed(tm, tsiam.params_from_jax(jp, tm), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    # parameter names and shapes follow the JAX tree (trunk_convs=1 keeps the pool after conv0)
    assert set(dict(tm.named_parameters())) == set(tsiam.params_from_jax(jp, tm))


@pytest.fixture(scope="module")
def jax_value_and_grads(pair):
    jm, jp, _, _ = pair
    x = _images(seed=3)
    out = {}
    for loss in LOSSES:
        fn = jax.jit(jax.value_and_grad(jsiam.make_loss_fn(jm, loss)))
        out[loss] = jax.tree_util.tree_map(np.asarray, fn(jp, x, LABELS))
    return x, out


@pytest.mark.parametrize("loss", LOSSES)
def test_loss_and_gradients_match_jax(pair, jax_value_and_grads, loss):
    jm, jp, tm, tp = pair
    x, ref = jax_value_and_grads
    want_value, want_grads = ref[loss]
    for p in tp.values():
        p.grad = None
    value = tsiam.make_loss_fn(tm, loss)(tp, torch.from_numpy(x), LABELS)
    value.backward()
    rtol = 1e-3 if loss in ("arcface", "cosface") else 1e-5
    np.testing.assert_allclose(float(value.detach()), float(want_value), rtol=rtol)
    want = tsiam.params_from_jax(want_grads, tm)
    for name, p in tp.items():
        w = want[name].numpy()
        if name == "class_weights" and loss not in ("arcface", "cosface"):
            assert p.grad is None and not w.any()
            continue
        scale = np.abs(w).max()
        assert scale > 0, name
        tol = (1e-3 if loss in ("arcface", "cosface") else 2e-4) * scale
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=tol, err_msg=name)


def test_unknown_loss_raises(pair):
    with pytest.raises(ValueError, match="Unknown loss"):
        tsiam.make_loss_fn(pair[2], "npair")


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_optimizer_arithmetic_matches_optax(kind):
    """Three updates with the same gradients; adamw decays by optax's 1e-4."""
    rng = np.random.default_rng(11)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    jopt = getattr(optax, kind)(1e-2)
    jparams = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = jopt.init(jparams)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = getattr(tsiam, kind)(1e-2)(list(tparams.values()))
    for g in grads:
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0,
                                       atol=1e-4 * 1e-2 * len(grads))
    adam_state = jstate[0]
    for i, k in enumerate(tparams):
        st = topt.state[tparams[k]]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam_state.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam_state.nu[k]), rtol=1e-6)
        assert int(st["step"]) == int(adam_state.count) == 3
    assert topt.defaults["weight_decay"] == (1e-4 if kind == "adamw" else 0)


def _train_state(seed=0, n_classes=4):
    model = tsiam.SiameseEmbedder("vgg11", embed_dim=16, trunk_convs=2, n_classes=n_classes)
    return model, tsiam.create_train_state(model, tsiam.adamw(1e-3), seed=seed, device="cpu")


def test_train_step_and_checkpoint_round_trip(tmp_path):
    model, state = _train_state()
    step = tsiam.train_step(model, tsiam.adamw(1e-3), loss="nt_xent")
    x = torch.from_numpy(_images(seed=4))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    for _ in range(2):
        state, loss = step(state, x, LABELS)
        assert torch.isfinite(loss) and loss.dim() == 0
    assert state.step == 2
    # every parameter moved, class_weights by weight decay alone
    assert all(not torch.equal(before[k], state.params[k]) for k in before)
    path = tckpt.save_train_state(str(tmp_path), state)
    assert path.endswith("step_00000002") and tckpt.latest_step(str(tmp_path)) == 2
    _, restored = _train_state(seed=1)
    tckpt.restore_train_state(str(tmp_path), restored)
    assert restored.step == 2
    for k in state.params:
        assert torch.equal(restored.params[k], state.params[k])
    live_opt, rest_opt = state.opt_state.state_dict(), restored.opt_state.state_dict()
    for i, st in live_opt["state"].items():
        for key, v in st.items():
            assert torch.equal(rest_opt["state"][i][key], v), key
    state, l1 = step(state, x, LABELS)
    restored, l2 = step(restored, x, LABELS)
    assert torch.equal(l1, l2)
    for k in state.params:
        assert torch.equal(restored.params[k], state.params[k])
    with pytest.raises(FileNotFoundError):
        tckpt.restore_train_state(str(tmp_path / "empty"), restored)
    with pytest.raises(TypeError, match="not the Adam"):
        tsiam.train_step(model, tsiam.adam(1e-3))(state, x, LABELS)


def test_neural_networks_reexports_the_trainer():
    assert neural_networks.SiameseEmbedder is tsiam.SiameseEmbedder
    assert neural_networks.train_step is tsiam.train_step
    assert set(neural_networks.__all__) == {"SiameseEmbedder", "TrainState", "create_train_state",
                                            "train_step", "embed"}


@pytest.fixture(scope="module")
def encoders():
    jm = jsiam.SiameseEmbedder(cfg_name="vgg11", embed_dim=16, trunk_convs=2)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                                    jnp.zeros((1, 32, 32, 3))))
    tm = tsiam.SiameseEmbedder("vgg11", embed_dim=16, trunk_convs=2)
    return (JSiameseEncoder(jm, jp, image_size=32),
            SiameseEncoder(tm, tsiam.params_from_jax(jp, tm), image_size=32, device="cpu"))


def _u8(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def test_encoder_matches_jax_on_uniform_and_ragged_batches(encoders):
    jenc, tenc = encoders
    same = _u8(5, (3, 32, 32, 3))  # already image_size: no resize
    resized = _u8(6, (2, 40, 48, 3))
    ragged = [_u8(7, (40, 48, 3)), _u8(8, (27, 33, 3)), _u8(9, (32, 32, 3))]
    for batch in (same, resized, ragged):
        got, want = tenc.encode(batch), jenc.encode(batch)
        assert got.shape == (len(batch), 16) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    alone = np.concatenate([tenc.encode(i) for i in ragged])
    np.testing.assert_allclose(tenc.encode(ragged), alone, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tenc.similarity_score(same, ragged),
                               jenc.similarity_score(same, ragged), rtol=0, atol=1e-5)
    assert tenc.output_dim == 16 and repr(tenc) == repr(jenc)


def test_encoder_from_train_state_and_encoding_map(encoders, tmp_path):
    import cv2

    jenc, tenc = encoders
    paths = []
    for i, shape in enumerate([(32, 32, 3), (36, 30, 3), (32, 32, 3)]):
        p = str(tmp_path / f"{i}.png")
        cv2.imwrite(p, _u8(20 + i, shape))
        paths.append(p)
    got, want = tenc.generate_encoding_map(paths, batch_size=2), jenc.generate_encoding_map(paths)
    assert list(got) == paths
    for p in paths:
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=2e-6)
    model, state = _train_state(n_classes=None)
    enc = SiameseEncoder.from_train_state(model, state, image_size=32, device="cpu")
    emb = enc.encode(_u8(3, (2, 32, 32, 3)))
    ref = tsiam.embed(model, state.params, torch.from_numpy(_u8(3, (2, 32, 32, 3))) / 255.0)
    np.testing.assert_array_equal(emb, ref.numpy())


def test_profiling_trace_timed_and_throughput(tmp_path, caplog):
    import logging

    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(4) @ torch.ones(4)
    assert any(e.key == "aten::dot" for e in prof.key_averages())
    assert list(tmp_path.glob("*.json"))
    with caplog.at_level(logging.INFO, logger="pyvisim_tpu_torch.profiling"):
        with profiling.timed("block"):
            pass
    assert "block:" in caplog.text
    meter = profiling.Throughput()
    meter.update(3)
    meter.update(4)
    assert meter.count == 7 and meter.rate > 0
    meter.reset()
    assert meter.count == 0
