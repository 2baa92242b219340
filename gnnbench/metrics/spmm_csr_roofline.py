"""B1's least time over its device time in the traced window, in percent
(``costs/spmm_csr.py``)."""
from gnnbench import readers


def read(obs):
    return readers.roofline_pct(obs, "spmm_csr")
