"""Device milliseconds of a training step's global-norm clip and AdamW
update: the ``device_ms`` of the port's ``train.clip`` and
``train.optimizer`` spans (median over the run's steps)."""
from gnnbench import spans


def read(obs):
    return spans.unit_median(spans.train_units, lambda s: spans.device_ms(
        s, {"train.clip", "train.optimizer"}))
