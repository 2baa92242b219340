"""Seconds of set-up in the graph build's host index (sort, CSR and CSC
offsets, edge-id maps): the port's ``graph.host_index`` spans, G's and,
where the cell trains, Gᵀ's, summed."""
from gnnbench import spans


def read(obs):
    return spans.setup_seconds("graph.host_index")
