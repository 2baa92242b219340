"""Graph kinds, one module each, named by a configuration's ``graph``.

A kind has ``make_inputs(ctx)`` (the host arrays, the node data and the
leaves from the cell's seed), ``build(ctx, inp)`` (the object the port's
step takes, the set-up parts timed into ``ctx.info["graph_build_s"]``),
``reference_inputs(inp, device, mask=None)`` (the reference's graph and
data) and ``n_edges(cfg)`` (the edges the costs count)."""
