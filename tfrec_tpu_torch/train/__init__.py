"""Training: losses and the train step (``step.TrainStepBuilder``)."""
