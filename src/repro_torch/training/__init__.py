"""The port's training path (the reference's ``repro.training``): AdamW
with float32 master weights, the synthetic data pipeline, npz
checkpoints and the train step."""
from repro_torch.training.checkpoint import (
    latest_step,
    restore_into,
    save_checkpoint,
)
from repro_torch.training.data import TokenPipeline, synthetic_batch
from repro_torch.training.optimizer import AdamWState, adamw_update, init_adamw
from repro_torch.training.train import grads_fn, loss_fn, train_step

__all__ = [
    "AdamWState",
    "TokenPipeline",
    "adamw_update",
    "grads_fn",
    "init_adamw",
    "latest_step",
    "loss_fn",
    "restore_into",
    "save_checkpoint",
    "synthetic_batch",
    "train_step",
]
