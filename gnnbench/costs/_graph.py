"""Shape facts of a port ``Graph`` that the kernels' costs need."""
import numpy as np


def rows_referenced(g, target: str) -> int:
    """Rows of an operand on ``target`` that some edge of ``g`` reads:
    sources with an out-edge (``u``), destinations with an in-edge
    (``v``), every edge (``e``)."""
    if target == "u":
        return int(np.count_nonzero(g.host.out_degrees))
    if target == "v":
        return int(np.count_nonzero(g.host.in_degrees))
    return int(g.n_edges)
