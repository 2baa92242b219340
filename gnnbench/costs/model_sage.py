"""Model FLOPs of GraphSAGE-mean (``reference/sage.py``) on ``n`` nodes
and ``e`` edges: the layers' products and the neighbour sums, with no
recomputation. Elementwise work (ReLU, dropout, the mean's divide, the
loss) is left out."""


def _dims(cfg):
    return ([cfg["features"]] + [cfg["hidden"]] * (cfg["layers"] - 1)
            + [cfg["classes"]])


def forward(cfg, n, e):
    d = _dims(cfg)
    return sum(e * d[i] + 2.0 * n * (2 * d[i]) * d[i + 1]
               for i in range(cfg["layers"]))


def train_step(cfg, n, e):
    """The forward, each layer's weight gradient, and the input gradient
    (product and neighbour sum on Gᵀ) of every layer but the first, whose
    input is the features."""
    d = _dims(cfg)
    back = 0.0
    for i in range(cfg["layers"]):
        back += 2.0 * n * (2 * d[i]) * d[i + 1]
        if i > 0:
            back += 2.0 * n * (2 * d[i]) * d[i + 1] + e * d[i]
    return forward(cfg, n, e) + back
