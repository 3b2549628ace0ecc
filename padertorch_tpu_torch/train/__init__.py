from padertorch_tpu_torch.train import trigger
from padertorch_tpu_torch.train import optimizer
from padertorch_tpu_torch.train import hooks
from padertorch_tpu_torch.train.trainer import Trainer, ContextTimerDict
from padertorch_tpu_torch.train.optimizer import (
    Optimizer, Adam, AdamW, SGD, Adadelta, Adafactor, Lion, Muon,
)
from padertorch_tpu_torch.train.hooks import (
    SummaryHook, CheckpointHook, ValidationHook, BackOffValidationHook,
    LRSchedulerHook, ProgressBarHook, StopTrainingHook, StopTraining,
    AnnealingHook, LossWeightAnnealingHook, ModelAttributeAnnealingHook,
    LRAnnealingHook, EMAHook, TorchProfilerHook, EnergyEstimateHook,
)
