"""Oxford Flowers-102 dataset.

Port of ``pyvisim_tpu/datasets/datasets.py``: download of 102flowers.tgz,
imagelabels.mat and setid.mat into ``cache_dir()/oxford_flower_dataset``
(on a thread pool, with HTTP status checks and retries), the integrity
check (8,189 images; splits of 6,149, 1,020 and 1,020), the *swapped*
train and test splits of the JAX package ('tstid' becomes train, so the
gallery has 6,149 images), purpose filtering with deterministic dedup,
``__getitem__ -> (RGB ndarray, label, path)`` with an optional
``transform``, and ``iter_batches`` of uint8 batches decoded through the
port's ``io`` layer. ``requests`` is imported only by the download.
"""
from __future__ import annotations

import os
import tarfile
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

from .._config import cache_dir, get_logger

logger = get_logger("datasets")

__all__ = ["OxfordFlowerDataset", "download_oxford_flowers_data"]

_DATASET_ROOT = os.path.join(str(cache_dir()), "oxford_flower_dataset")
_IMAGE_DIR = os.path.join(_DATASET_ROOT, "images", "jpg")
_IMAGE_LABEL_FILE = os.path.join(_DATASET_ROOT, "labels.mat")
_SETID_FILE = os.path.join(_DATASET_ROOT, "setid.mat")
_FILES_FLOWER_DATA = {
    "images": "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/102flowers.tgz",
    "labels": "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/imagelabels.mat",
    "setid": "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/setid.mat",
}
OXFORD_NUM_IMAGES = 8189
NUM_TEST_IMG = 6149  # 'tstid' length (becomes the train split)
NUM_TRAIN_IMG = 1020
NUM_VAL_IMG = 1020


def _download_file(url: str, dest: str, retries: int = 3) -> None:
    import requests

    for attempt in range(retries):
        try:
            logger.info("Downloading %s -> %s", url, dest)
            with requests.get(url, stream=True, timeout=60) as r:
                r.raise_for_status()
                with open(dest, "wb") as f:
                    for chunk in r.iter_content(chunk_size=1 << 16):
                        if chunk:
                            f.write(chunk)
            return
        except Exception as e:  # noqa: BLE001
            logger.warning("download attempt %d failed: %s", attempt + 1, e)
            if attempt == retries - 1:
                raise


def _extract(archive: str, extract_to: str) -> None:
    logger.info("Extracting %s -> %s", archive, extract_to)
    if archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(extract_to)
    elif archive.endswith((".tgz", ".tar.gz")):
        with tarfile.open(archive, "r:gz") as tf:
            tf.extractall(extract_to, filter="data")


def _download_and_process(name: str, url: str) -> None:
    ext = os.path.splitext(url)[-1]
    dest = os.path.join(_DATASET_ROOT, f"{name}{ext}")
    _download_file(url, dest)
    if dest.endswith((".zip", ".tgz", ".tar.gz")):
        stem = os.path.splitext(os.path.basename(dest))[0]
        _extract(dest, os.path.join(_DATASET_ROOT, stem))
        os.remove(dest)


def download_oxford_flowers_data() -> None:
    """Download the three dataset files in parallel threads."""
    logger.info("Starting download process for Oxford Flowers.")
    os.makedirs(_DATASET_ROOT, exist_ok=True)
    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = [
            pool.submit(_download_and_process, name, url)
            for name, url in _FILES_FLOWER_DATA.items()
        ]
        for f in futures:
            f.result()
    logger.info("Oxford Flowers dataset downloaded and processed successfully.")


def _data_downloaded() -> bool:
    return (
        os.path.isdir(_DATASET_ROOT)
        and os.path.isdir(_IMAGE_DIR)
        and os.path.isfile(_IMAGE_LABEL_FILE)
        and os.path.isfile(_SETID_FILE)
    )


def _check_data_integrity() -> bool:
    """Label count, split sizes and image count as Flowers-102 has them."""
    import scipy.io

    try:
        labels = scipy.io.loadmat(_IMAGE_LABEL_FILE)["labels"].squeeze().tolist()
        if len(labels) != OXFORD_NUM_IMAGES:
            logger.warning("Expected %d labels, got %d.", OXFORD_NUM_IMAGES, len(labels))
            return False
        mat = scipy.io.loadmat(_SETID_FILE)
        if (
            len(mat["tstid"].squeeze()) != NUM_TEST_IMG
            or len(mat["valid"].squeeze()) != NUM_VAL_IMG
            or len(mat["trnid"].squeeze()) != NUM_TRAIN_IMG
        ):
            logger.warning("setid.mat has incorrect lengths.")
            return False
    except Exception as e:  # noqa: BLE001
        logger.warning("Error reading dataset metadata: %s", e)
        return False
    jpgs = [f for f in os.listdir(_IMAGE_DIR) if f.lower().endswith(".jpg")]
    if len(jpgs) != OXFORD_NUM_IMAGES:
        logger.warning("Expected %d .jpg images, got %d.", OXFORD_NUM_IMAGES, len(jpgs))
        return False
    return True


class OxfordFlowerDataset:
    """Oxford Flowers-102 with the JAX package's swapped train/test splits.

    A map-style dataset (``__len__`` / ``__getitem__``), usable with
    ``torch.utils.data.DataLoader``. Without the data in ``cache_dir()``, or
    with data that fails the integrity check, it downloads them.

    :param transform: optional callable applied to each decoded RGB image.
    :param purpose: 'train' | 'validation' | 'test' or a list of them
        (duplicates rejected).
    """

    def __init__(
        self,
        transform: Optional[Callable] = None,
        purpose: str | list[str] = "train",
    ) -> None:
        self.transform = transform
        self.purpose = [purpose] if isinstance(purpose, str) else purpose
        if len(set(self.purpose)) < len(self.purpose):
            raise ValueError(
                "Duplicate purposes found in the list. Please provide unique purposes."
            )
        if not _data_downloaded() or not _check_data_integrity():
            download_oxford_flowers_data()
        self.labels = self._load_labels(_IMAGE_LABEL_FILE)
        self.image_paths = self._load_image_paths()
        self.train_ids, self.val_ids, self.test_ids = self._load_set_ids(_SETID_FILE)
        self.image_paths, self.labels = self._filter_by_purpose()

    @staticmethod
    def _load_labels(labels_file: str) -> list[int]:
        import scipy.io

        return scipy.io.loadmat(labels_file)["labels"].squeeze().tolist()

    @staticmethod
    def _load_image_paths() -> list[str]:
        images = sorted(f for f in os.listdir(_IMAGE_DIR) if f.endswith(".jpg"))
        return [os.path.join(_IMAGE_DIR, img) for img in images]

    @staticmethod
    def _load_set_ids(set_id_file: str):
        """Train and test IDs are *swapped* against the official split, as
        in the JAX package, so that the train set holds 6,149 images."""
        import scipy.io

        mat = scipy.io.loadmat(set_id_file)
        train_ids = mat["tstid"].squeeze().tolist()
        val_ids = mat["valid"].squeeze().tolist()
        test_ids = mat["trnid"].squeeze().tolist()
        return train_ids, val_ids, test_ids

    def _filter_by_purpose(self):
        """The chosen splits' images in ascending ID order, each once."""
        chosen_ids: list[int] = []
        for p in self.purpose:
            match p:
                case "train":
                    chosen_ids += self.train_ids
                case "validation":
                    chosen_ids += self.val_ids
                case "test":
                    chosen_ids += self.test_ids
                case _:
                    raise ValueError(
                        f"Unknown purpose: {p}. Must be 'train', 'validation', or 'test'."
                    )
        chosen_ids = sorted(set(chosen_ids))
        filtered_paths = [self.image_paths[i - 1] for i in chosen_ids]
        filtered_labels = [self.labels[i - 1] for i in chosen_ids]
        return filtered_paths, filtered_labels

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int):
        """-> (RGB uint8 ndarray, label, path)."""
        from ..io import imread_rgb

        img_path = self.image_paths[idx]
        label = self.labels[idx] if self.labels else -1
        image = imread_rgb(img_path)
        if self.transform:
            image = self.transform(image)
        return image, label, img_path

    def iter_batches(
        self, batch_size: int, image_size: int | None = None, drop_remainder: bool = False
    ) -> Iterator[tuple[np.ndarray, np.ndarray, list[str]]]:
        """Yield ``(images (B, H, W, 3) uint8, labels (B,), paths)`` batches,
        decoded (and resized to ``image_size`` squared when it is given)
        through the host IO layer."""
        from ..io import imread_rgb_batch

        n = len(self)
        for start in range(0, n, batch_size):
            paths = self.image_paths[start : start + batch_size]
            if drop_remainder and len(paths) < batch_size:
                return
            labels = np.asarray(self.labels[start : start + batch_size])
            if image_size is not None:
                imgs = imread_rgb_batch(paths, target_size=(image_size, image_size))
                imgs = np.asarray(imgs)
            else:
                imgs = imread_rgb_batch(paths)
            yield imgs, labels, paths
