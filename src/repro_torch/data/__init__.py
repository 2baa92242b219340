"""Datasets and host-side pipeline of the port."""
from .pipeline import Prefetcher, RequestQueue, ServeRequest, prefetch
from .sampler import MiniBatch, NeighborSampler, SampledBlock
from .synthetic import (DATASETS, bipartite_ratings, make_node_dataset,
                        relational_graph, rmat_graph, sbm_graph)

__all__ = ["Prefetcher", "prefetch", "ServeRequest", "RequestQueue",
           "DATASETS", "make_node_dataset", "rmat_graph", "sbm_graph",
           "bipartite_ratings", "relational_graph", "NeighborSampler",
           "SampledBlock", "MiniBatch"]
