"""GNN apps of the port: GCN, GraphSAGE and GAT full-graph inference."""
