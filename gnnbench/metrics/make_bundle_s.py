"""Seconds of set-up in the model's graph bundle (edge norms on the
host, the plan cache's packs, their copy to the card): the port's
``gnn.make_bundle`` span, in the trainer's set-up or the server's."""
from gnnbench import spans


def read(obs):
    return spans.setup_seconds("gnn.make_bundle")
