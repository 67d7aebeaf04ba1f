"""The port's losses against the JAX package's: each value and its
gradient (autograd against ``jax.grad``) on the same seed-made inputs.

Tolerances: float32 values and gradients to rtol 1e-5 and atol 1e-6 (the
two stacks sum in other orders; the margin-softmax losses, whose logits
are scaled by 16 here, to rtol 1e-4 and atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvisim_tpu import losses as jl
from pyvisim_tpu_torch import losses as tl


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seg(seed=0, b=2, c=4, h=6, w=5, absent=None):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, c, h, w)).astype(np.float32)
    labels = rng.integers(0, c, size=(b, h, w))
    if absent is not None:
        labels[labels == absent] = (absent + 1) % c
    one_hot = np.eye(c, dtype=np.float32)[labels].transpose(0, 3, 1, 2)
    return logits, one_hot


def _value_and_grad_pair(jfn, tfn, x, *rest):
    """(JAX value, JAX grad wrt x, port value, port grad wrt x)."""
    jv, jg = jax.value_and_grad(lambda a: jfn(a, *rest))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tv = tfn(tx, *[torch.as_tensor(r) if isinstance(r, np.ndarray) else r for r in rest])
    tv.backward()
    return np.asarray(jv), np.asarray(jg), tv.detach().numpy(), tx.grad.numpy()


def _assert_pair(pair, rtol=1e-5, atol=1e-6):
    jv, jg, tv, tg = pair
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)
    np.testing.assert_allclose(tg, jg, rtol=rtol, atol=atol)
    assert np.abs(jg).max() > 0


SEG_CASES = {
    "dice": (jl.dice_loss, tl.dice_loss, {}),
    "dice_log": (jl.dice_loss, tl.dice_loss, {"log_loss": True}),
    "dice_classes_smooth": (jl.dice_loss, tl.dice_loss, {"classes": [0, 2], "smooth": 0.5}),
    "dice_binary": (jl.dice_loss, tl.dice_loss, {"mode": "binary"}),
    "dice_ignore": (jl.dice_loss, tl.dice_loss, {"ignore_index": 0}),
    "focal": (jl.focal_loss, tl.focal_loss, {}),
    "focal_alpha": (jl.focal_loss, tl.focal_loss, {"alpha": [0.1, 0.2, 0.3, 0.4], "gamma": 1.5}),
    "focal_binary": (jl.focal_loss, tl.focal_loss, {"mode": "binary", "alpha": 0.25}),  # C = 1
    "focal_ignore": (jl.focal_loss, tl.focal_loss, {"ignore_index": 1}),
    "hybrid": (jl.hybrid_focal_dice_loss, tl.hybrid_focal_dice_loss,
               {"dice_weight": 0.3, "focal_weight": 0.7, "ignore_index": 2}),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segmentation_loss_and_grad_match_jax(case):
    jfn, tfn, kw = SEG_CASES[case]
    logits, one_hot = _seg(absent=3)  # class 3 absent: its dice term is masked
    if case == "focal_binary":  # binary focal flattens probabilities and labels alike
        logits, one_hot = logits[:, :1], one_hot[:, :1]
    _assert_pair(_value_and_grad_pair(lambda a, t: jfn(a, t, **kw),
                                      lambda a, t: tfn(a, t, **kw), logits, one_hot))


def test_soft_dice_score_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.random((3, 7)).astype(np.float32), rng.random((3, 7)).astype(np.float32)
    for dims in (None, (1,)):
        _assert_pair(_value_and_grad_pair(
            lambda x, y: jnp.sum(jl.soft_dice_score(x, y, smooth=0.1, dims=dims)),
            lambda x, y: torch.sum(tl.soft_dice_score(x, y, smooth=0.1, dims=dims)), a, b))


def test_loss_modules_match_functions_and_check_arguments():
    logits, one_hot = _seg(seed=2)
    x, t = torch.from_numpy(logits), torch.from_numpy(one_hot)
    assert torch.equal(tl.MultiClassDiceLoss("multiclass", log_loss=True)(x, t),
                       tl.dice_loss(x, t, log_loss=True))
    assert torch.equal(tl.FocalLoss("binary", alpha=0.3)(x[:, :1], t[:, :1]),
                       tl.focal_loss(x[:, :1], t[:, :1], mode="binary", alpha=0.3))
    assert torch.equal(tl.HybridFocalDiceLoss("multiclass", dice_weight=0.4, focal_weight=0.6)(x, t),
                       tl.hybrid_focal_dice_loss(x, t, dice_weight=0.4, focal_weight=0.6))
    np.testing.assert_allclose(
        float(tl.FocalLoss("multiclass")(x, t)),
        float(jl.FocalLoss("multiclass")(logits, one_hot)), rtol=1e-5)
    with pytest.raises(ValueError, match="Unknown mode"):
        tl.MultiClassDiceLoss("softmax")
    with pytest.raises(ValueError, match="Unknown mode"):
        tl.FocalLoss("softmax")
    # The JAX wrapper's default weights (1, 1) fail its own check, and so do the port's.
    with pytest.raises(ValueError, match="must be equal to 1.0"):
        jl.HybridFocalDiceLoss("multiclass")
    with pytest.raises(ValueError, match="must be equal to 1.0"):
        tl.HybridFocalDiceLoss("multiclass")
    with pytest.raises(ValueError, match="must be equal to 1.0"):
        tl.hybrid_focal_dice_loss(x, t, dice_weight=0.5, focal_weight=0.6)
    assert isinstance(tl.FocalLoss("binary"), torch.nn.Module)


def _emb(seed, b=8, d=6):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def test_triplet_loss_matches_jax():
    a, p, n = _emb(3), _emb(4), _emb(5)
    _assert_pair(_value_and_grad_pair(jl.triplet_loss, tl.triplet_loss, a, p, n))
    _assert_pair(_value_and_grad_pair(lambda x, y, z: jl.triplet_loss(x, y, z, margin=1.0),
                                      lambda x, y, z: tl.triplet_loss(x, y, z, margin=1.0), p, a, n))


def test_contrastive_loss_matches_jax():
    same = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32)
    _assert_pair(_value_and_grad_pair(jl.contrastive_loss, tl.contrastive_loss, _emb(6), _emb(7),
                                      same))


@pytest.mark.parametrize("labels", [[0, 0, 1, 1, 2, 2, 3, 3], [0, 0, 0, 1, 2, 3, 4, 4]])
def test_nt_xent_loss_matches_jax(labels):
    """The second batch holds rows with no positive, which count for nothing."""
    labels = np.asarray(labels)
    _assert_pair(_value_and_grad_pair(lambda e, lab: jl.nt_xent_loss(e, lab, temperature=0.2),
                                      lambda e, lab: tl.nt_xent_loss(e, lab, temperature=0.2),
                                      _emb(8), labels))


@pytest.mark.parametrize("kind", ["arcface", "cosface"])
def test_margin_softmax_loss_matches_jax(kind):
    emb, w = _emb(9), _emb(10, b=5)
    labels = np.array([0, 1, 2, 3, 4, 0, 1, 2])
    jfn = lambda e, cw: jl.margin_softmax_loss(e, labels, cw, kind=kind, scale=16.0)
    tfn = lambda e, cw: tl.margin_softmax_loss(e, torch.from_numpy(labels), cw, kind=kind, scale=16.0)
    _assert_pair(_value_and_grad_pair(jfn, tfn, emb, w), rtol=1e-4, atol=1e-5)
    # ... and the gradient of the class weights
    _assert_pair(_value_and_grad_pair(lambda cw, e: jfn(e, cw), lambda cw, e: tfn(e, cw), w, emb),
                 rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="Unknown margin-softmax kind"):
        tl.margin_softmax_loss(torch.from_numpy(emb), labels, torch.from_numpy(w), kind="sphere")


@pytest.mark.parametrize("kind", ["arcface", "cosface"])
@pytest.mark.parametrize("stray", [-1, 4])
def test_margin_softmax_loss_takes_labels_outside_the_classes(kind, stray):
    """A label outside [0, C) gets an all-zero one-hot row, as
    ``jax.nn.one_hot`` gives it: the row adds nothing to the sum but counts
    in the mean. Default scale; loss to rel 1e-5, gradients to 1e-5 of the
    largest."""
    emb, w = _emb(11, b=6), _emb(12, b=4)
    labels = np.array([0, 1, 2, 3, stray, 1])
    jfn = lambda e, cw: jl.margin_softmax_loss(e, labels, cw, kind=kind)
    tfn = lambda e, cw: tl.margin_softmax_loss(e, torch.from_numpy(labels), cw, kind=kind)
    for pair in (_value_and_grad_pair(jfn, tfn, emb, w),
                 _value_and_grad_pair(lambda cw, e: jfn(e, cw), lambda cw, e: tfn(e, cw), w, emb)):
        jv, jg, tv, tg = pair
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=0)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * np.abs(jg).max())
        assert np.abs(jg).max() > 0
