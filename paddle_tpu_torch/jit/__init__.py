"""The training step (the port of paddle_tpu/jit's TrainStep)."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
