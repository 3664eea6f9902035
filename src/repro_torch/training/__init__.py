"""Training substrate of the port: optimizer, step builder, data,
checkpoints and the fault-tolerant elastic trainer."""
from .checkpoint import CheckpointManager
from .data import DataConfig, SyntheticLM, TokenFile, make_pipeline
from .ft import ElasticTrainer, FTConfig, StepEvent
from .optimizer import OptimizerConfig, adamw_init, adamw_update, schedule
from .train import TrainConfig, init_train_state, make_train_step

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "schedule",
           "TrainConfig", "make_train_step", "init_train_state",
           "CheckpointManager", "DataConfig", "SyntheticLM", "TokenFile",
           "make_pipeline", "ElasticTrainer", "FTConfig", "StepEvent"]
