"""B4's least time over its device time in the traced window, in percent
(``costs/binary_reduce_csr.py``)."""
from gnnbench import readers


def read(obs):
    return readers.roofline_pct(obs, "binary_reduce_csr")
