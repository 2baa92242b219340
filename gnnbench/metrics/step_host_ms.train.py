"""Host milliseconds for a call of the port's training step to return,
before the loss read: the step's Python and launches (median over the
traced run's host-timed steps)."""
from gnnbench import readers


def read(obs):
    return readers.part_median(obs, "host_ms")
