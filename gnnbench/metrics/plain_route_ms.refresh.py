"""Device milliseconds a refresh spends in aggregation calls on a plain
route (PyTorch, not the port's kernels): the ``device_ms`` of the port's
innermost ``agg.*`` spans whose ``route`` is not ``kernel``, summed per
refresh (median over the run's refreshes)."""
from gnnbench import spans


def read(obs):
    return spans.unit_median(spans.refresh_units, spans.plain_route_ms)
