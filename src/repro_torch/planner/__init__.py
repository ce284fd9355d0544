"""Planner, ported: the roofline cost model (H100 data-sheet peaks),
stage and serving graphs built from model configs, and HVLB_CC placement
onto slices of a GPU cluster."""
from .cost_model import (HW, hbm_bytes, layer_costs, model_flops,
                         stage_graph_costs, total_flops)
from .placement import (PlacementPlan, gpu_slice_topology, plan_placement,
                        replan)
from .taskgraph import (model_stage_graph, pipeline_graph,
                        serving_query_graph)

__all__ = [
    "HW", "layer_costs", "total_flops", "model_flops", "hbm_bytes",
    "stage_graph_costs", "PlacementPlan", "gpu_slice_topology",
    "plan_placement", "replan", "model_stage_graph", "pipeline_graph",
    "serving_query_graph",
]
