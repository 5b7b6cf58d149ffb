"""The port's training stack: steps (``step``, on one device or a mesh)
and the GridPilot-actuated trainer (``trainer``)."""
from repro_torch.train.step import StepBundle, build_step_bundle
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["StepBundle", "build_step_bundle", "Trainer", "TrainerConfig"]
