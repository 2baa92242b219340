"""Device milliseconds of a training step's forward and loss: the
``device_ms`` of the port's ``train.forward`` span (median over the
run's steps)."""
from gnnbench import spans


def read(obs):
    return spans.unit_median(spans.train_units,
                             lambda s: spans.device_ms(s, {"train.forward"}))
