"""Milliseconds of a refresh outside the port's ``serve.refresh`` span
(which ends when the logits are on the device): the copy to the host and
the swap into the row cache (median over the traced run's host-timed
refreshes)."""
from gnnbench import readers


def read(obs):
    return readers.part_median(obs, "store_ms")
