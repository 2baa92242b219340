"""PyTorch/CUDA port of the graph-aggregation system in ``src/repro``.

The package mirrors ``repro``'s subpackage layout (``core``, ``kernels``,
``models.gnn``, ``models.lm``, ``configs``, ``data``, ``obs``,
``substrate``, ``optim``, ``launch``, ``checkpoint``) so each module's
counterpart is easy to find. It imports ``torch``, numpy and the
standard library only; the JAX package is its reference in the tests.

Entry points take an explicit ``device`` and default to ``"cuda"``: they
run on the card unless the caller asks for ``"cpu"``, and a missing GPU
raises instead of falling back.
"""
