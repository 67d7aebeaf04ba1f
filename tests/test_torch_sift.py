"""SIFT stage by stage in both stacks: each stage of the port is fed the
JAX package's output of the stage before it, so a tiny difference in one
stage does not compound into the next.

The JAX package runs its XLA path (``patch_backend="xla"``, its CPU
default); the port runs its plain versions, which the CUDA kernels repeat
(``tests/test_torch_cuda.py`` holds them against each other on the card).
One module-scoped JAX run of one configuration (process size 96, 160
keypoints) serves every stage test.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvisim_tpu.features import _features as JF
from pyvisim_tpu.ops import gaussian as jgauss
from pyvisim_tpu.ops import sift as J
from pyvisim_tpu_torch import profiling
from pyvisim_tpu_torch.features import RootSIFT
from pyvisim_tpu_torch.ops import gaussian as tgauss
from pyvisim_tpu_torch.ops import sift as T
from pyvisim_tpu_torch.ops.cuda import ingest as KI
from pyvisim_tpu_torch.ops.cuda import sift_window as K

PS, MAX_KP = 96, 160
JCFG = J.SiftConfig(process_size=PS, max_keypoints=MAX_KP, patch_backend="xla")
TCFG = T.SiftConfig(process_size=PS, max_keypoints=MAX_KP)
KW_REFINE = dict(n_layers=TCFG.n_octave_layers, steps=TCFG.refine_steps,
                 reach=TCFG.refine_reach, contrast_threshold=TCFG.contrast_threshold,
                 edge_threshold=TCFG.edge_threshold)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here is small: one intra-op thread keeps it from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blob_image(seed=0, h=110, w=150):
    """Gaussian blobs of random sizes and brightness plus a little noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(70):
        y, x = rng.integers(4, h - 4), rng.integers(4, w - 4)
        s = rng.uniform(1.2, 6)
        img += np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s)) * rng.uniform(60, 200)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def np_(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def t_(x, dtype=torch.float32):
    return torch.from_numpy(np.array(np_(x))).to(dtype)


DESC_MULT = 3.0 * 1.4142135623730951 * 2.5


def _jax_windows(atlas, cand, fn, classes, mult, *extra):
    """JAX's per-keypoint XLA ``fn`` (``_orientation`` or ``_descriptor``)
    over the keypoints, one radius class at a time, as ``_sift_core``
    runs it."""
    offsets, heights, widths = (jnp.asarray(a, jnp.int32) for a in J._atlas_layout(JCFG))
    o = cand["octave"]
    need = jnp.round(mult * cand["scl_oct"])
    cls = jnp.minimum(jnp.searchsorted(jnp.asarray(classes, jnp.float32), need),
                      len(classes) - 1)
    total = None
    for ci, radius in enumerate(classes):
        pv = cand["valid"] & (cls == ci)

        def one(l, r, c, s, v, ro, h, w, *more, radius=radius):
            return fn(atlas, h, w, JCFG.desc_patch_radius, l, r, c, s, *more, v, JCFG, ro,
                      radius=radius)

        out = jax.vmap(one)(cand["layer"], cand["r"], cand["c"], cand["scl_oct"], pv,
                            offsets[o], heights[o], widths[o], *extra)
        out = out if isinstance(out, tuple) else (out,)
        out = tuple(jnp.where(pv.reshape((-1,) + (1,) * (a.ndim - 1)), a, 0) for a in out)
        total = out if total is None else tuple(a + b for a, b in zip(total, out))
    return total


@jax.jit
def _jax_stages(lb):
    """The JAX package's intermediates for one letterboxed image, in one
    compiled program."""
    x = lb.astype(jnp.float32)[None]
    up = jax.image.resize(x, (1, 2 * PS, 2 * PS), "bilinear")
    base = jgauss.gaussian_blur_batch(up, math.sqrt(JCFG.sigma**2 - 1.0))
    gauss, dog = J._build_pyramids(base, JCFG)
    ranked, detected = [], []
    for o in range(JCFG.n_octaves):
        budget = JCFG.octave_budget(o)
        ranked.append(J._rank_candidates(dog[o][0], budget, JCFG))
        out = J._detect_octave(dog[o], budget, JCFG)
        out["octave"] = jnp.full(out["r"].shape, o, jnp.int32)
        detected.append(out)
    merged = {k: jnp.concatenate([p[k] for p in detected], axis=1) for k in detected[0]}
    _, top = jax.lax.top_k(merged["response"], min(MAX_KP, merged["response"].shape[1]))
    cand = {k: jnp.take_along_axis(v, top, axis=1)[0] for k, v in merged.items()}
    return dict(up=up, base=base, gauss=gauss, dog=dog, ranked=ranked, detected=detected,
                cand=cand, **_jax_atlas(tuple(g[0] for g in gauss)))


def _jax_atlas(gauss):
    """JAX's folded atlas of one image's Gaussian octaves, and the dense
    bf16 stacks it folds."""
    return dict(atlas=J._grad_atlas(gauss, JCFG),
                stacks=[J._magang_stacks(g, 0, jnp.bfloat16) for g in gauss])


@jax.jit
def _jax_orientation(atlas, cand):
    """JAX's orientation of the keypoints ``cand`` on ``atlas``: one
    compiled program for every atlas of the run's shapes."""
    return _jax_windows(atlas, cand, J._orientation, JCFG.ori_radius_classes, 4.5)


@pytest.fixture(scope="module")
def jax_run():
    lb = J._letterbox(blob_image(), PS)
    run = _jax_stages(jnp.asarray(lb))
    ori = _jax_orientation(run["atlas"], run["cand"])
    (desc,) = jax.jit(_jax_windows, static_argnums=(2, 3, 4))(
        run["atlas"], run["cand"], J._descriptor, JCFG.desc_radius_classes, DESC_MULT, ori[0])
    return dict(run, ori=ori, desc=desc, lb=lb)


def test_gaussian_kernel_and_blur_match_jax():
    np.testing.assert_array_equal(tgauss.gaussian_kernel1d(1.7), jgauss.gaussian_kernel1d(1.7))
    x = np.random.default_rng(0).uniform(0, 255, (2, 37, 52)).astype(np.float32)
    for sigma in (0.8, 1.6, 3.1):
        want = np_(jgauss.gaussian_blur_batch(jnp.asarray(x), sigma))
        got = tgauss.gaussian_blur_batch(torch.from_numpy(x), sigma).numpy()
        np.testing.assert_allclose(got, want, atol=1e-3)
    hwc = x.transpose(1, 2, 0)[None]
    np.testing.assert_allclose(
        tgauss.gaussian_blur_batch(torch.from_numpy(hwc), 1.2).numpy(),
        np_(jgauss.gaussian_blur_batch(jnp.asarray(hwc), 1.2)), atol=1e-3)


def test_upscale_and_pyramid_match_jax(jax_run):
    """The 2x bilinear upscale and, fed JAX's blurred base, every Gaussian
    level and DoG of every octave, to 1e-3 at 0..255 scale."""
    lb = torch.from_numpy(jax_run["lb"]).to(torch.float32)[None]
    np.testing.assert_allclose(T._upscale2x(lb).numpy(), np_(jax_run["up"]), atol=1e-4)
    gauss, dog = T._build_pyramids(t_(jax_run["base"]), TCFG)
    assert len(gauss) == len(jax_run["gauss"]) == TCFG.n_octaves == 4
    for o in range(TCFG.n_octaves):
        np.testing.assert_allclose(gauss[o].numpy(), np_(jax_run["gauss"][o]), atol=1e-3)
        np.testing.assert_allclose(dog[o].numpy(), np_(jax_run["dog"][o]), atol=1e-3)


def _same_candidates(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[0], np.asarray(w).astype(g.numpy().dtype))


def test_extrema_and_ranking_match_jax(jax_run):
    """Fed JAX's DoG, the same candidates in the same order, every octave."""
    for o in range(TCFG.n_octaves):
        got = T._rank_candidates(t_(jax_run["dog"][o]), TCFG.octave_budget(o), TCFG)
        _same_candidates(got, jax_run["ranked"][o])


def test_ranking_tie_order_matches_jax():
    """Many extrema of equal bf16 score, more than 8 in a row and more than
    the budget: the per-row and the global top-k keep the lower index
    first, as XLA's top_k does."""
    rng = np.random.default_rng(1)
    dog = np.zeros((5, 40, 48), np.float32)
    for layer in (1, 2, 3):
        for r in range(5, 35, 2):
            for c in range(5, 43, 2):
                if rng.random() < 0.8:
                    dog[layer, r, c] = rng.choice([3.0, 3.0, 3.01, 5.0]) * rng.choice([-1, 1])
    for budget in (16, 200):
        want = J._rank_candidates(jnp.asarray(dog), budget, JCFG)
        got = T._rank_candidates(torch.from_numpy(dog)[None], budget, TCFG)
        _same_candidates(got, want)
    vals = np.asarray(want[0])
    assert vals.size - np.unique(vals).size > 150  # the input does tie


def _refine_args(jax_run):
    """JAX's DoGs and ranked candidates of every octave as the arguments of
    one refine call: the candidates octave after octave."""
    ranked = [[torch.from_numpy(np.array(a)).to(torch.int32) for a in r[1:4]]
              + [torch.from_numpy(np.array(r[4]))] for r in jax_run["ranked"]]
    layer, r, c, valid = (torch.cat([rk[i] for rk in ranked]) for i in range(4))
    counts = [rk[3].numel() for rk in ranked]
    img = torch.zeros(sum(counts), dtype=torch.int32)
    return [t_(d) for d in jax_run["dog"]], img, layer, r, c, valid, counts


def test_refinement_matches_jax(jax_run):
    """Fed JAX's DoGs and candidates, every octave in one call: the same
    kept candidates at the same positions, offsets and contrast to 1e-5
    (JAX refines per octave and sums the stencils in a (27, 10) matmul,
    the port term by term)."""
    dogs, img, layer, r, c, valid, counts = _refine_args(jax_run)
    got = K.refine_reference(dogs, img, layer, r, c, valid, counts=counts, **KW_REFINE)
    want = {k: np.concatenate([np.asarray(d[k])[0] for d in jax_run["detected"]])
            for k in ("valid", "layer", "r", "c", "xr", "xc", "xi", "response")}
    ok = got.ok.numpy()
    np.testing.assert_array_equal(ok, want["valid"])
    for name, key in (("layer", "layer"), ("row", "r"), ("col", "c")):
        np.testing.assert_array_equal(getattr(got, name).numpy()[ok], want[key][ok])
    for name in ("xr", "xc", "xi"):
        np.testing.assert_allclose(getattr(got, name).numpy()[ok], want[name][ok], atol=1e-5)
    np.testing.assert_allclose(np.abs(got.contrast.numpy()[ok]), want["response"][ok], atol=1e-6)
    assert len(counts) == TCFG.n_octaves and ok.sum() > 40


def test_refinement_of_all_octaves_equals_one_octave_at_a_time(jax_run):
    """One call over every octave gives, bit for bit, what one call per
    octave gives, the fits included."""
    dogs, img, layer, r, c, valid, counts = _refine_args(jax_run)
    together, fits = K.refine_reference(dogs, img, layer, r, c, valid, counts=counts,
                                        return_steps=True, **KW_REFINE)
    start = 0
    for dog, k in zip(dogs, counts):
        part = slice(start, start + k)
        alone, fits_alone = K.refine_reference(
            [dog], img[part], layer[part], r[part], c[part], valid[part], counts=[k],
            return_steps=True, **KW_REFINE)
        assert all(torch.equal(a[part], b) for a, b in zip(together, alone))
        assert torch.equal(fits[part], fits_alone)
        start += k
    assert start == together.ok.numel() and fits.sum() > 0


def test_refine_refuses_what_the_kernel_does_not_take(jax_run):
    """At most 16 octaves, counts that cover the candidates, one B."""
    dogs, img, layer, r, c, valid, counts = _refine_args(jax_run)
    args = (img, layer, r, c, valid)
    with pytest.raises(ValueError, match="1 to 16"):
        K.refine(dogs[:1] * 17, *args, counts=[0] * 16 + [img.numel()], **KW_REFINE)
    with pytest.raises(ValueError, match="counts"):
        K.refine(dogs, *args, counts=counts[:-1] + [counts[-1] + 1], **KW_REFINE)
    with pytest.raises(ValueError, match="counts"):
        K.refine(dogs, *args, counts=counts[:-1], **KW_REFINE)
    with pytest.raises(ValueError, match="B of dogs"):
        K.refine(dogs[:-1] + [dogs[-1].repeat(2, 1, 1, 1)], *args, counts=counts, **KW_REFINE)
    with pytest.raises(TypeError):
        K.refine(dogs[:-1] + [dogs[-1].double()], *args, counts=counts, **KW_REFINE)


def _port_atlas(stacks):
    """The port's flat atlas and octave table from JAX's (L, 2, H, W)
    stacks of one image."""
    parts, table, off = [], [], 0
    for s in stacks:
        a = t_(s).permute(0, 2, 3, 1).contiguous().to(torch.bfloat16)  # (L, H, W, 2)
        parts.append(a.reshape(-1))
        table.append([off, a.shape[1], a.shape[2]])
        off += a.numel()
    return torch.cat(parts), torch.tensor(table, dtype=torch.int64)


def test_gradient_atlas_matches_jax(jax_run):
    """Magnitude and angle (bf16, zeroed border ring) of layers 1..L; the
    two packages' atan2 and sqrt may round to neighbouring bf16 values."""
    for g, want in zip(jax_run["gauss"], jax_run["stacks"]):
        got = T._magang_stacks(t_(g), torch.bfloat16)[0].to(torch.float32).numpy()
        want = np_(want).transpose(0, 2, 3, 1)
        assert not got[:, [0, -1], :, 0].any() and not got[:, :, [0, -1], 0].any()
        diff = np.abs(got - want)
        ulp = np.maximum(np.abs(want), 1e-30) * 2.0**-7
        assert (diff <= ulp).all()
        assert (diff == 0).mean() > 0.999


def _window_args(jax_run, classes, mult, stacks=None):
    cand = {k: torch.from_numpy(np.asarray(v)) for k, v in jax_run["cand"].items()}
    atlas, octaves = _port_atlas(jax_run["stacks"] if stacks is None else stacks)
    n = cand["valid"].numel()
    return dict(atlas=atlas, octaves=octaves, img=torch.zeros(n, dtype=torch.int32),
                octave=cand["octave"], layer=cand["layer"], row=cand["r"], col=cand["c"],
                scl=cand["scl_oct"], radius=T._radius_class(cand["scl_oct"], mult, classes),
                valid=cand["valid"], n_layers=TCFG.n_octave_layers)


def test_orientation_matches_jax(jax_run):
    """Fed JAX's atlas and keypoints: the same second-peak flags, angles to
    1e-4 rad (the 36 bins sum in another f32 order)."""
    valid = np.asarray(jax_run["cand"]["valid"])
    want = [np.asarray(a) for a in jax_run["ori"]]
    got = K.orientation_reference(**_window_args(jax_run, TCFG.ori_radius_classes, 4.5))
    np.testing.assert_array_equal(got[2].numpy(), want[2] > 0)
    np.testing.assert_allclose(got[0].numpy()[valid], want[0][valid], atol=1e-4)
    np.testing.assert_allclose(got[1].numpy()[want[2] > 0], want[1][want[2] > 0], atol=1e-4)
    assert valid.sum() > 40 and (want[2] > 0).any()


def test_orientation_of_one_bin_windows_matches_jax(jax_run):
    """Every window pixel's gradient points 20 degrees up (the octaves are
    ramps f(c - tan(20 deg) r) with f' > 0), so each histogram has one
    nonzero bin: the same angles and second-peak flags as JAX, and the
    angle of bin 2."""
    ramps = []
    for g in jax_run["gauss"]:
        levels, h, w = g[0].shape
        rr, cc = np.mgrid[:h, :w].astype(np.float32)
        u = cc - np.float32(np.tan(np.pi / 9)) * rr
        ramp = u + 0.002 * (u + 100.0) ** 2
        ramps.append(jnp.asarray(np.stack([ramp * (1 + 0.25 * i) for i in range(levels)])))
    run = _jax_atlas(tuple(ramps))
    want = [np.asarray(a) for a in _jax_orientation(run["atlas"], jax_run["cand"])]
    got = K.orientation_reference(**_window_args(jax_run, TCFG.ori_radius_classes, 4.5,
                                                 stacks=run["stacks"]))
    valid = np.asarray(jax_run["cand"]["valid"])
    np.testing.assert_array_equal(got[2].numpy(), want[2] > 0)
    np.testing.assert_allclose(got[0].numpy()[valid], want[0][valid], atol=1e-4)
    assert not got[2].any()
    np.testing.assert_allclose(got[0].numpy()[valid], 2 * 2 * np.pi / 36, atol=1e-6)


def test_descriptor_matches_jax(jax_run):
    """Fed JAX's atlas, keypoints and angles: descriptors within 1 unit,
    exact on >= 99 % of the valid keypoints' entries."""
    want = np.asarray(jax_run["desc"])
    args = _window_args(jax_run, TCFG.desc_radius_classes, DESC_MULT)
    got = K.descriptor_reference(**args, theta=t_(jax_run["ori"][0])).numpy()
    valid = np.asarray(jax_run["cand"]["valid"])
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff[valid] == 0).mean() >= 0.99
    assert not got[~valid].any()


def test_root_sift_matches_jax():
    d = np.random.default_rng(2).integers(0, 256, (3, 7, 128)).astype(np.float32)
    d[0, 0] = 0.0
    np.testing.assert_allclose(T._apply_root_sift(torch.from_numpy(d)).numpy(),
                               np_(J._apply_root_sift(jnp.asarray(d))), rtol=1e-6, atol=1e-7)


LETTERBOX_SIZES = [(1, 1), (1, 37), (37, 1), (17, 23), (23, 17), (64, 64), (65, 63), (100, 7),
                   (7, 100), (127, 129), (130, 95), (333, 211), (211, 333), (400, 401),
                   (96, 96), (50, 96), (96, 50), (513, 17), (31, 700), (255, 256)]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_letterbox_matches_jax(dtype):
    """OpenCV's INTER_LINEAR without OpenCV: uint8 bit for bit (the port
    follows OpenCV's fixed-point SIMD blend); float32 to 1e-3 at 0..255
    scale (OpenCV's IPP path computes its weights in a precision of its
    own; 2.5e-4 is the largest difference on these sizes)."""
    rng = np.random.default_rng(3)
    for h, w in LETTERBOX_SIZES:
        img = rng.uniform(0, 255, (h, w))
        img = img.astype(np.uint8) if dtype == "uint8" else img.astype(np.float32)
        for size in (64, 96):
            got, want = T._letterbox(img, size), J._letterbox(img, size)
            assert got.dtype == want.dtype and got.shape == want.shape
            if dtype == "uint8":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, atol=1e-3)


def _raw_image(rng, h, w, kind):
    shape = {"gray": (h, w), "rgb": (h, w, 3), "rgba": (h, w, 4)}[kind]
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _plain_ingest(images, size):
    """The device route's plain version on one chunk: its tables as
    ``sift_descriptors`` builds them, then ``gray_letterbox_reference``."""
    raw, layout, taps = T._chunk_layout(images, size)
    return KI.gray_letterbox_reference(torch.from_numpy(raw), layout, taps, size).numpy()


@pytest.mark.parametrize("size", [64, 96, 512])
@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
@pytest.mark.parametrize("hw", LETTERBOX_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_gray_letterbox_plain_version_matches_host_and_jax(hw, kind, size):
    """The ingest kernel's plain version (gray and letterbox of raw uint8
    pixels in one pass) equals the host route, the port's and the JAX
    package's, bit for bit: an image that keeps its size (64x64 and 96x96
    at their size) included."""
    img = _raw_image(np.random.default_rng(hw[0] * 1000 + hw[1]), *hw, kind)
    got = _plain_ingest([img], size)
    assert got.shape == (1, size, size) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[0], T._letterbox(T._to_gray_u8(img), size))
    np.testing.assert_array_equal(got[0], J._letterbox(JF._to_gray_u8(img), size))


def test_gray_letterbox_plain_version_on_a_ragged_chunk():
    """One call over images of mixed shapes and channels, some of one shape
    (their taps shared), as a batch array and as a list."""
    rng = np.random.default_rng(5)
    images = [_raw_image(rng, h, w, kind) for h, w, kind in
              [(50, 70, "rgb"), (30, 20, "gray"), (64, 64, "rgba"), (50, 70, "rgb"),
               (1, 1, "rgb"), (130, 95, "gray"), (50, 70, "gray")]]
    raw, layout, taps = T._chunk_layout(images, 64)
    assert len(taps) == 4 * sum(layout[i, 4] + layout[i, 5] for i in (0, 1, 2, 4, 5))
    got = _plain_ingest(images, 64)
    for out, img in zip(got, images):
        np.testing.assert_array_equal(out, T._letterbox(T._to_gray_u8(img), 64))
    batch = np.stack([_raw_image(rng, 37, 53, "rgb") for _ in range(3)])
    np.testing.assert_array_equal(
        _plain_ingest(batch, 64), np.stack([T._letterbox(T._to_gray_u8(im), 64) for im in batch]))


def test_gray_letterbox_refuses_what_the_kernel_does_not_take():
    img = np.zeros((5, 7, 3), np.uint8)
    raw, layout, taps = T._chunk_layout([img], 16)
    raw = torch.from_numpy(raw)
    with pytest.raises(TypeError, match="uint8"):
        KI.gray_letterbox(raw.float(), layout, taps, 16)
    with pytest.raises(ValueError, match="contiguous"):
        KI.gray_letterbox(raw.reshape(5, 21)[:, ::2], layout, taps, 16)
    two = layout.copy()
    two[0, 3] = 2
    with pytest.raises(ValueError, match="not 2"):
        KI.gray_letterbox(raw, two, taps, 16)
    with pytest.raises(ValueError, match="outside raw"):
        KI.gray_letterbox(raw[:-1], layout, taps, 16)
    with pytest.raises(ValueError, match="taps must index"):
        KI.gray_letterbox(raw, layout, taps + 7, 16)
    with pytest.raises(ValueError, match="2-D gray or 3-D"):
        T._chunk_layout([np.zeros((2, 3, 4, 1), np.uint8)], 16)


def test_raw_rgb_images_give_the_host_routes_descriptors(monkeypatch):
    """``sift_descriptors`` and the extractor on raw uint8 RGB(A) images
    (gray and letterbox in the ingest kernel's plain version) give the
    host route's desc and mask on the same images turned gray first; the
    counters tell the routes apart."""
    rng = np.random.default_rng(8)
    images = []
    for seed, (h, w) in enumerate([(110, 150), (90, 120), (110, 150)]):
        gray = blob_image(seed, h, w).astype(np.float64)
        tint = rng.uniform(0.6, 1.2, 3)
        images.append(np.clip(gray[..., None] * tint, 0, 255).astype(np.uint8))
    images[1] = np.concatenate([images[1], np.full((90, 120, 1), 7, np.uint8)], axis=2)
    grays = [T._to_gray_u8(im) for im in images]
    with profiling.record() as rec:
        got = T.sift_descriptors(images, TCFG, root_sift=True, run_on="cpu")
    assert rec.counters()["ingest.on_card"] == 3 and "ingest.on_host" not in rec.counters()
    assert "ingest.gray" not in {sp.name for sp in rec.spans}
    with monkeypatch.context() as m:
        m.setattr(T, "_all_uint8", lambda images: False)
        with profiling.record() as rec:
            want = T.sift_descriptors(grays, TCFG, root_sift=True, run_on="cpu")
        assert rec.counters()["ingest.on_host"] == 3
    assert want["mask"].sum() > 20
    for key in ("desc", "mask"):
        np.testing.assert_array_equal(got[key], want[key])
    ext = RootSIFT(max_keypoints=MAX_KP, process_size=PS, device="cpu")
    desc, mask = ext.extract_batch(np.stack([images[0], images[2]]))
    np.testing.assert_array_equal(desc, want["desc"][[0, 2]])
    np.testing.assert_array_equal(mask, want["mask"][[0, 2]])


def test_sift_config_checks_as_jax():
    for bad in (dict(ori_radius_classes=(12,)), dict(desc_radius_classes=(24, 32)),
                dict(desc_radius_classes=(24, 32, 48))):
        with pytest.raises(ValueError):
            J.SiftConfig(**bad)
        with pytest.raises(ValueError):
            T.SiftConfig(**bad)
    with pytest.raises(ValueError, match="atlas_dtype"):
        T.SiftConfig(atlas_dtype="float16")
    for ps, up in ((512, True), (96, False), (200, True)):
        j, t = J.SiftConfig(process_size=ps, upscale=up), T.SiftConfig(process_size=ps, upscale=up)
        assert (j.base_size, j.n_octaves) == (t.base_size, t.n_octaves)
        assert [j.octave_budget(o) for o in range(j.n_octaves)] == \
            [t.octave_budget(o) for o in range(t.n_octaves)]
        assert J._pyramid_sigmas(j) == T._pyramid_sigmas(t)
