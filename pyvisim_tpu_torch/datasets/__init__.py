"""Datasets (port of ``pyvisim_tpu/datasets``): Oxford Flowers-102 and the
synthetic corpora for machines without the data."""
from .datasets import OxfordFlowerDataset, download_oxford_flowers_data
from .synthetic import expand_encodings, make_class_images, make_retrieval_corpus

__all__ = [
    "OxfordFlowerDataset",
    "download_oxford_flowers_data",
    "make_class_images",
    "make_retrieval_corpus",
    "expand_encodings",
]
