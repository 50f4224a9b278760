"""Graph-based alignment: GNN drift estimation on atom point clouds."""

from putting_dune_torch.graph_alignment.model import AlignmentGraphNetwork

__all__ = ['AlignmentGraphNetwork']
