"""Model FLOPs of GAT (``reference/gat.py``) on ``n`` nodes and ``e``
edges: per layer the projection, the two attention terms, the edge
logits, the edge softmax (max, shift, exp, sum, divide: five operations
an edge and head) and the weighted sum; the backward counts the weight
gradient, the input gradient of every layer but the first, and twice the
forward's edge and attention work. ELU, LeakyReLU, dropout and the loss
are left out."""


def _layers(cfg):
    d = cfg["features"]
    for i in range(cfg["layers"]):
        last = i == cfg["layers"] - 1
        heads = 1 if last else cfg["heads"]
        out = cfg["classes"] if last else cfg["hidden"]
        yield i, d, heads, out
        d = heads * out


def _layer(n, e, d, heads, out):
    proj = 2.0 * n * d * heads * out
    edge = (4.0 * n * heads * out + e * heads + 5.0 * e * heads
            + 2.0 * e * heads * out)
    return proj, edge


def forward(cfg, n, e):
    return sum(sum(_layer(n, e, d, h, f)) for _, d, h, f in _layers(cfg))


def train_step(cfg, n, e):
    total = 0.0
    for i, d, h, f in _layers(cfg):
        proj, edge = _layer(n, e, d, h, f)
        total += 2.0 * proj + 3.0 * edge + (proj if i > 0 else 0.0)
    return total
