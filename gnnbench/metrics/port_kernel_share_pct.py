"""Percent of the device's time in the traced window spent in the port's
own kernels (B1–B5), against PyTorch's and cuBLAS's."""
from gnnbench import readers


def read(obs):
    return readers.port_share_pct(obs)
