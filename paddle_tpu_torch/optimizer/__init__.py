"""Optimizers and learning-rate schedulers (the port of
paddle_tpu/optimizer)."""
from . import lr
from .lr import (CosineAnnealingDecay, CyclicLR, ExponentialDecay,
                 InverseTimeDecay, LambdaDecay, LinearWarmup, LRScheduler,
                 MultiplicativeDecay, MultiStepDecay, NaturalExpDecay,
                 NoamDecay, OneCycleLR, PiecewiseDecay, PolynomialDecay,
                 ReduceOnPlateau, StepDecay)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DGCMomentum, Lamb, LarsMomentum, Momentum, Optimizer,
                        RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum",
           "DGCMomentum", "LRScheduler", "NoamDecay", "PiecewiseDecay",
           "NaturalExpDecay", "InverseTimeDecay", "PolynomialDecay",
           "LinearWarmup", "ExponentialDecay", "MultiStepDecay", "StepDecay",
           "LambdaDecay", "MultiplicativeDecay", "CosineAnnealingDecay",
           "ReduceOnPlateau", "OneCycleLR", "CyclicLR", "lr"]
