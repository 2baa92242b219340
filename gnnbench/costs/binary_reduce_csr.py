"""B4, ``binary_reduce_csr(g, B, E, binop, mean)``: out (n_dst, d) = Σ
over a row's edges of B[src] ⊗ E[eid] (E alone for ``copy_rhs``), E in
caller edge order."""
from gnnbench.costs._graph import rows_referenced

INDEX_BYTES = 4


def describe(args):
    g, B, E = args["g"], args.get("B"), args["E"]
    d = int(E.shape[1]) if B is None else int(B.shape[1])
    return {"n_dst": int(g.n_dst), "n_edges": int(g.n_edges),
            "rows_u": 0 if B is None else rows_referenced(g, "u"),
            "d": d, "de": int(E.shape[1]), "node": B is not None,
            "itemsize": int(E.element_size())}


def cost(c):
    """``(bytes, flops)``: indptr, the edge-id map and, with a node
    operand, the source index; the rows and edge values read and the
    output; one operation per edge and feature for each of ⊗ and the
    sum."""
    idx = INDEX_BYTES * (c["n_dst"] + 1
                         + c["n_edges"] * (2 if c["node"] else 1))
    vals = (c["rows_u"] * c["d"] + c["n_edges"] * c["de"]
            + c["n_dst"] * c["d"])
    ops = (2.0 if c["node"] else 1.0) * c["n_edges"] * c["d"]
    return idx + c["itemsize"] * vals, ops
