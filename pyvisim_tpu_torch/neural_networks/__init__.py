"""Neural networks: the Siamese embedding network (port of
``pyvisim_tpu/neural_networks``, a re-export of ``models.siamese``)."""
from ..models.siamese import (
    SiameseEmbedder,
    TrainState,
    create_train_state,
    embed,
    train_step,
)

__all__ = ["SiameseEmbedder", "TrainState", "create_train_state", "train_step", "embed"]
