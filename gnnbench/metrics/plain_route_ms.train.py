"""Device milliseconds a training step spends in aggregation calls on a
plain route (PyTorch, not the port's kernels): the ``device_ms`` of the
port's innermost ``agg.*`` spans whose ``route`` is not ``kernel``,
forward and backward, summed per step (median over the run's steps).
A plain route that autograd differentiates has no backward span."""
from gnnbench import spans


def read(obs):
    return spans.unit_median(spans.train_units, spans.plain_route_ms)
