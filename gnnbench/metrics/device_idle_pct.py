"""Percent of the traced window in which no kernel, copy or set ran on the
device."""
from gnnbench import readers


def read(obs):
    return readers.idle_pct(obs)
