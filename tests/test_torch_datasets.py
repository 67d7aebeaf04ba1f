"""The port's OxfordFlowerDataset on the fabricated 12-image tree of
``tests/test_datasets.py`` (no network): swapped splits, purpose
filtering, integrity checks and the download they start, batch iteration,
the downloader's retries. Each test is that file's, run on the port; two
more hold the port's images and batches equal to the JAX package's and
start the download where the tree is missing."""
import os

import cv2
import numpy as np
import pytest
import scipy.io as scipy_io

from pyvisim_tpu.datasets import datasets as jds
from pyvisim_tpu_torch.datasets import datasets as ds


@pytest.fixture
def fake_oxford(tmp_path, monkeypatch):
    """A 12-image mini-Oxford: tstid=6 (-> train), valid=3, trnid=3 (-> test)."""
    root = tmp_path / "oxford_flower_dataset"
    img_dir = root / "images" / "jpg"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(1, 13):
        img = (rng.random((20, 24, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(img_dir / f"image_{i:05d}.jpg"), img)
    labels = np.arange(1, 13) % 4 + 1
    scipy_io.savemat(str(root / "labels.mat"), {"labels": labels.reshape(1, -1)})
    scipy_io.savemat(
        str(root / "setid.mat"),
        {
            "tstid": np.array([[1, 2, 3, 4, 5, 6]]),
            "valid": np.array([[7, 8, 9]]),
            "trnid": np.array([[10, 11, 12]]),
        },
    )
    for mod in (ds, jds):
        monkeypatch.setattr(mod, "_DATASET_ROOT", str(root))
        monkeypatch.setattr(mod, "_IMAGE_DIR", str(img_dir))
        monkeypatch.setattr(mod, "_IMAGE_LABEL_FILE", str(root / "labels.mat"))
        monkeypatch.setattr(mod, "_SETID_FILE", str(root / "setid.mat"))
        monkeypatch.setattr(mod, "OXFORD_NUM_IMAGES", 12)
        monkeypatch.setattr(mod, "NUM_TEST_IMG", 6)
        monkeypatch.setattr(mod, "NUM_VAL_IMG", 3)
        monkeypatch.setattr(mod, "NUM_TRAIN_IMG", 3)

    def no_download():
        raise RuntimeError("no network in test")

    monkeypatch.setattr(ds, "download_oxford_flowers_data", no_download)
    monkeypatch.setattr(jds, "download_oxford_flowers_data", no_download)
    return root, labels


def test_swapped_splits(fake_oxford):
    _, labels = fake_oxford
    train = ds.OxfordFlowerDataset(purpose="train")
    # the JAX package swaps tstid into train
    assert len(train) == 6
    assert [os.path.basename(p) for p in train.image_paths] == [
        f"image_{i:05d}.jpg" for i in range(1, 7)
    ]
    test = ds.OxfordFlowerDataset(purpose="test")
    assert len(test) == 3
    assert [os.path.basename(p) for p in test.image_paths] == [
        f"image_{i:05d}.jpg" for i in (10, 11, 12)
    ]


def test_combined_purposes_and_labels(fake_oxford):
    _, labels = fake_oxford
    both = ds.OxfordFlowerDataset(purpose=["validation", "test"])
    assert len(both) == 6
    for path, label in zip(both.image_paths, both.labels):
        i = int(os.path.basename(path)[6:11])
        assert label == labels[i - 1]


def test_duplicate_purpose_rejected(fake_oxford):
    with pytest.raises(ValueError, match="Duplicate purposes"):
        ds.OxfordFlowerDataset(purpose=["train", "train"])
    with pytest.raises(ValueError, match="Unknown purpose"):
        ds.OxfordFlowerDataset(purpose="banana")


def test_getitem_and_transform(fake_oxford):
    data = ds.OxfordFlowerDataset(purpose="validation")
    img, label, path = data[0]
    assert img.ndim == 3 and img.shape[2] == 3
    assert isinstance(label, (int, np.integer))
    transformed = ds.OxfordFlowerDataset(
        purpose="validation", transform=lambda im: im[:5, :5]
    )
    img2, _, _ = transformed[0]
    assert img2.shape[:2] == (5, 5)


def test_iter_batches(fake_oxford):
    data = ds.OxfordFlowerDataset(purpose="train")
    batches = list(data.iter_batches(batch_size=4, image_size=16))
    assert len(batches) == 2
    imgs, labels, paths = batches[0]
    assert imgs.shape == (4, 16, 16, 3) and imgs.dtype == np.uint8
    assert len(labels) == len(paths) == 4
    drop = list(data.iter_batches(batch_size=4, image_size=16, drop_remainder=True))
    assert len(drop) == 1


def test_integrity_failure_triggers_download(fake_oxford, monkeypatch):
    root, _ = fake_oxford
    # corrupt: delete one image -> count mismatch -> download attempted
    imgs = sorted((root / "images" / "jpg").glob("*.jpg"))
    imgs[0].unlink()
    called = {}

    def fake_download():
        called["yes"] = True
        raise RuntimeError("no network in test")

    monkeypatch.setattr(ds, "download_oxford_flowers_data", fake_download)
    with pytest.raises(RuntimeError, match="no network"):
        ds.OxfordFlowerDataset(purpose="train")
    assert called.get("yes")


def test_download_retries_on_failure(tmp_path, monkeypatch):
    """The downloader checks the HTTP status, retries transient failures
    and raises after the last attempt."""
    calls = {"n": 0}

    class FakeResponse:
        def __init__(self, ok):
            self.ok = ok

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def raise_for_status(self):
            if not self.ok:
                raise RuntimeError("HTTP 503")

        def iter_content(self, chunk_size):
            yield b"payload"

    def fake_get(url, stream=True, timeout=60):
        calls["n"] += 1
        return FakeResponse(ok=calls["n"] >= 3)

    import types

    monkeypatch.setitem(
        __import__("sys").modules, "requests", types.SimpleNamespace(get=fake_get)
    )
    dest = str(tmp_path / "file.bin")
    ds._download_file("http://example/file.bin", dest, retries=3)
    assert calls["n"] == 3
    assert open(dest, "rb").read() == b"payload"

    calls["n"] = -10  # will keep failing for all retries
    with pytest.raises(RuntimeError, match="HTTP 503"):
        ds._download_file("http://example/file.bin", dest, retries=2)


@pytest.mark.parametrize("purpose", ["train", ["validation", "test"]])
def test_images_labels_and_batches_equal_jax(fake_oxford, purpose):
    port, ref = ds.OxfordFlowerDataset(purpose=purpose), jds.OxfordFlowerDataset(purpose=purpose)
    assert port.image_paths == ref.image_paths and port.labels == ref.labels
    for i in range(len(port)):
        (a, la, pa), (b, lb, pb) = port[i], ref[i]
        np.testing.assert_array_equal(a, b)
        assert la == lb and pa == pb
    for (a, la, pa), (b, lb, pb) in zip(port.iter_batches(4, 16), ref.iter_batches(4, 16)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


def test_missing_tree_starts_the_download(tmp_path, monkeypatch):
    """Without the tree the dataset downloads it (patched here to raise)."""
    monkeypatch.setattr(ds, "_DATASET_ROOT", str(tmp_path / "absent"))

    def fake_download():
        raise RuntimeError("no network in test")

    monkeypatch.setattr(ds, "download_oxford_flowers_data", fake_download)
    with pytest.raises(RuntimeError, match="no network"):
        ds.OxfordFlowerDataset()
