"""Graph-based alignment: GNN drift estimation on atom point clouds."""
