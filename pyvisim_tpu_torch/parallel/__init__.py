"""Multi-rank parallelism on ``torch.distributed``: device meshes, sharded
encode, similarity and SIFT, cluster-sharded encodes, and distributed
vocabulary and Siamese training.

Port of ``pyvisim_tpu/parallel``. JAX runs a mesh from one controller
process; here each rank is a process that calls the same function with the
same global inputs and gets the same global result (see ``mesh``). A
world is started by ``torchrun`` or :func:`init_distributed`, or on one host
by :class:`~pyvisim_tpu_torch.parallel.local.LocalWorld`.
"""
from .distributed import init_distributed, make_hybrid_mesh, plan_hybrid_mesh
from .mesh import NamedSharding, P, data_sharding, make_mesh, replicated
from .sharded import (
    cluster_sharded_fisher_encode,
    cluster_sharded_vlad_encode,
    distributed_gmm_fit,
    distributed_kmeans_fit,
    distributed_pca_fit,
    pad_to_multiple,
    sharded_cosine_similarity,
    sharded_encode,
    sharded_sift_batch,
)
from .train import make_sharded_trainer, shard_train_state

__all__ = [
    "init_distributed",
    "plan_hybrid_mesh",
    "make_hybrid_mesh",
    "make_mesh",
    "data_sharding",
    "replicated",
    "P",
    "NamedSharding",
    "pad_to_multiple",
    "sharded_cosine_similarity",
    "sharded_encode",
    "sharded_sift_batch",
    "cluster_sharded_vlad_encode",
    "cluster_sharded_fisher_encode",
    "distributed_kmeans_fit",
    "distributed_pca_fit",
    "distributed_gmm_fit",
    "make_sharded_trainer",
    "shard_train_state",
]
