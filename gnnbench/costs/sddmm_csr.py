"""B3, ``sddmm_csr(g, op, lhs_target, lhs, rhs_target, rhs)``: out
(n_edges, d) in caller edge order, out[e] = lhs[i(e)] ⊗ rhs[j(e)] for
node targets through the caller-order index arrays, edge targets
directly; with ``heads`` > 1 a ``dot`` per head, out (n_edges, heads)."""
from gnnbench.costs._graph import rows_referenced

INDEX_BYTES = 4
# output width of each op on widths (dl, dr), as the kernel computes it:
# a dot gives one output per head
DOT = ("dot",)


def _out_width(op, dl, dr, heads):
    if op == "copy":
        return dl
    if op in DOT:
        return heads
    return max(dl, dr)


def describe(args):
    g, lhs, rhs = args["g"], args["lhs"], args.get("rhs")
    lt, rt = args["lhs_target"], args.get("rhs_target")
    dl = int(lhs.shape[1])
    dr = 0 if rhs is None else int(rhs.shape[1])
    return {"n_edges": int(g.n_edges), "op": args["op"],
            "targets": [lt] + ([] if rhs is None else [rt]),
            "rows": [rows_referenced(g, lt)]
            + ([] if rhs is None else [rows_referenced(g, rt)]),
            "widths": [dl] + ([] if rhs is None else [dr]),
            "d_out": _out_width(args["op"], dl, dr,
                                int(args.get("heads", 1))),
            "itemsize": int(lhs.element_size())}


def cost(c):
    """``(bytes, flops)``: one caller-order index array per node operand,
    the rows read, the output; one operation per output element (a dot
    product's multiply-adds per input element)."""
    idx = INDEX_BYTES * c["n_edges"] * sum(t in ("u", "v")
                                           for t in c["targets"])
    rows = sum(r * w for r, w in zip(c["rows"], c["widths"]))
    out = c["n_edges"] * c["d_out"]
    flops = (2.0 * c["n_edges"] * max(c["widths"]) if c["op"] in DOT
             else float(out))
    return idx + c["itemsize"] * (rows + out), flops
