"""graphsage-reddit [arXiv:1706.02216] + its four assigned shapes (port of
``repro.configs.gnn_archs``).

d_feat / n_classes follow each shape's source dataset: cora (full_graph_sm),
reddit (minibatch_lg), ogbn-products, and a 30-atom molecule batch.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec, build_gnn_cell
from repro_torch.models.gnn import SAGEConfig

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7,
                          kind="full"),
    "minibatch_lg": dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                         d_feat=602, n_classes=41, fanouts=(15, 10), kind="sampled"),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                         n_classes=47, kind="full"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=2,
                     kind="pool"),
}


def cfg_for(shape: dict) -> SAGEConfig:
    return SAGEConfig(
        name="graphsage-reddit", n_layers=2, d_in=shape["d_feat"], d_hidden=128,
        n_classes=shape["n_classes"], aggregator="mean",
        fanouts=tuple(shape.get("fanouts", (25, 10))),
        edge_chunk=1_048_576,
    )


def spec() -> ArchSpec:
    def build(shape_name, layout):
        shape = GNN_SHAPES[shape_name]
        return build_gnn_cell(cfg_for(shape), shape_name, shape, layout)

    return ArchSpec(arch_id="graphsage-reddit", family="gnn",
                    shapes=GNN_SHAPES, build=build)


def small_gnn() -> SAGEConfig:
    return SAGEConfig(name="small-sage", n_layers=2, d_in=16, d_hidden=32,
                      n_classes=4, fanouts=(5, 3), edge_chunk=512)
