"""Training: losses, the train step (``step.TrainStepBuilder``) and the
config-driven driver (``trainer.Trainer``, ``trainer.run``)."""

from tfrec_tpu_torch.train.losses import make_loss  # noqa: F401
from tfrec_tpu_torch.train.step import TrainStepBuilder, init_state  # noqa: F401
