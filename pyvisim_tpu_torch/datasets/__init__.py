"""Datasets (port of ``pyvisim_tpu/datasets``): the synthetic corpora.
``OxfordFlowerDataset`` comes with a later slice."""
from .synthetic import expand_encodings, make_class_images, make_retrieval_corpus

__all__ = ["make_class_images", "make_retrieval_corpus", "expand_encodings"]
