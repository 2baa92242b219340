"""GNN apps of the port: GCN, GraphSAGE and GAT (serving and training),
and the relational apps R-GCN, GC-MC, MoNet and LGNN (forwards; R-GCN
served)."""
