"""B3's least time over its device time in the traced window, in percent
(``costs/sddmm_csr.py``)."""
from gnnbench import readers


def read(obs):
    return readers.roofline_pct(obs, "sddmm_csr")
