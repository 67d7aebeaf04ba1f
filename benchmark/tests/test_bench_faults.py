"""The check fails a broken timed path, and the control: a run of each
kind of cell on the CPU at a tiny size (the harness's look for a card
skipped), with a fault planted in the program underneath, or with the
reference one precision lower in the program's place, comes out not
correct under the cell's own limits. One chip runs the cells, so no
exchange between chips can be left out."""
import numpy as np
import pytest
import torch

from benchmark import check, control, run
from benchmark.tests.conftest import GALLERY, QUERY, tiny_sift, tiny_vgg

CELLS = {"vgg16-int8-vlad256.gallery": (tiny_vgg, GALLERY),
         "rootsift-vlad256.gallery": (tiny_sift, GALLERY),
         "vgg16-int8-vlad256.query": (tiny_vgg, QUERY)}


def judged(cell_name: str, seed: int = 11, patch=None, precision=None) -> tuple[bool, dict]:
    make_cfg, mix = CELLS[cell_name]
    cell = run.Cell({"name": cell_name, "config": "x", "traffic": "y", "chips": 1}, seed, "cpu",
                    cfg=make_cfg(), mix=mix)
    if patch is not None:
        patch(cell)
    cell.warm_up()
    loop = cell.window(0.4)
    cell.free()
    numbers, _ = cell.check_numbers(loop, precision=precision)
    return check.judge(numbers, check.limits(cell_name))


def stale_encode(cell):
    """A step that returns its state unchanged: each encode returns the
    encodings it held before the call, the previous call's."""
    inner, held = cell.encoder.encode, []

    def encode(images):
        out = inner(images)
        held.append(out)
        return held.pop(0) if len(held) > 1 else out

    cell.encoder.encode = encode


def half_the_rows(cell):
    """Half of each image's descriptors left out, the aggregate taken over
    the rest."""
    inner = cell.encoder._encode_core

    def core(desc, mask, *args):
        mask = mask.clone()
        mask[:, mask.shape[1] // 2:] = 0
        return inner(desc, mask, *args)

    cell.encoder._encode_core = core


def altered_encoding(cell):
    """An answer altered where it is produced: each batch's encodings come
    back one row out of place."""
    inner = cell.encoder._encode_core

    def core(*args):
        return torch.roll(inner(*args), 1, dims=0)

    cell.encoder._encode_core = core


def stale_query(cell):
    """A step that returns its state unchanged: each query returns the
    answer held before the call, the previous query's."""
    inner, held = cell.index.query_vectors, []

    def query_vectors(vecs, k=5):
        held.append(inner(vecs, k))
        return held.pop(0) if len(held) > 1 else held[0]

    cell.index.query_vectors = query_vectors


def half_the_gallery(cell):
    """Half of the gallery left out of the scan."""
    cell.index._n = len(cell.index) // 2


def altered_answer(cell):
    """An answer altered where it is produced: the best row's id is replaced
    by its neighbour's."""
    inner = cell.index.query_vectors

    def query_vectors(vecs, k=5):
        scores, ids = inner(vecs, k)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % cell.cfg["index"]["rows"]
        return scores, ids

    cell.index.query_vectors = query_vectors


GALLERY_FAULTS = [stale_encode, half_the_rows, altered_encoding]
QUERY_FAULTS = [stale_query, half_the_gallery, altered_answer]


@pytest.mark.parametrize("fault", GALLERY_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell_name", ["vgg16-int8-vlad256.gallery", "rootsift-vlad256.gallery"])
def test_a_broken_gallery_path_is_not_correct(cell_name, fault):
    ok, checks = judged(cell_name, patch=fault)
    assert not ok, checks


@pytest.mark.parametrize("fault", QUERY_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell_name", ["vgg16-int8-vlad256.query"])
def test_a_broken_query_path_is_not_correct(cell_name, fault):
    ok, checks = judged(cell_name, patch=fault)
    assert not ok, checks


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_the_control_is_not_correct(cell_name):
    ref = run.importlib.import_module(
        f"benchmark.reference.{CELLS[cell_name][0]()['system']}")
    ok, checks = judged(cell_name, precision=control.control_precision(ref))
    assert not ok, checks


@pytest.mark.parametrize("cell_name", ["rootsift-vlad256.gallery"])
def test_the_sound_path_is_correct(cell_name):
    ok, checks = judged(cell_name)
    assert ok, checks
    assert all(np.isfinite(c["value"]) for c in checks.values())
