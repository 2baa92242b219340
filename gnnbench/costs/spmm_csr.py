"""B1, ``spmm_csr(g, B, weight, mean)``: out (n_dst, d) = Σ over a row's
edges of B[src] (times a canonical-order edge weight), or their mean."""
from gnnbench.costs._graph import rows_referenced

INDEX_BYTES = 4
WEIGHT_BYTES = 4


def describe(args):
    B, g = args["B"], args["g"]
    return {"n_dst": int(g.n_dst), "n_edges": int(g.n_edges),
            "rows_u": rows_referenced(g, "u"), "d": int(B.shape[1]),
            "itemsize": int(B.element_size()),
            "weighted": args.get("weight") is not None}


def cost(c):
    """``(bytes, flops)``: indptr and the source index, the weight when
    there is one, the rows read and the output; a multiply-add per edge
    and feature."""
    idx = INDEX_BYTES * (c["n_dst"] + 1 + c["n_edges"])
    w = WEIGHT_BYTES * c["n_edges"] if c["weighted"] else 0
    rows = c["itemsize"] * c["d"] * (c["rows_u"] + c["n_dst"])
    return idx + w + rows, 2.0 * c["n_edges"] * c["d"]
