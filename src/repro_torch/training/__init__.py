"""Training in the port: the AdamW trainer over the train-mode forward, on
one device or over a ``(data, model)`` mesh of processes, the data streams
and checkpoints.  Port of ``repro.training``."""
from repro_torch.training.adamw import (AdamWConfig, AdamWState, adamw_init,
                                        adamw_update)
from repro_torch.training.checkpoint import (latest_checkpoint,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import DataConfig, make_dataset
from repro_torch.training.train_loop import (MeshTrainStep, TrainConfig,
                                             make_train_step, train)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "latest_checkpoint", "restore_checkpoint", "save_checkpoint",
           "DataConfig", "make_dataset", "MeshTrainStep", "TrainConfig",
           "make_train_step", "train"]
