"""Core MISS library of the port: estimators, error model, sampling, the
bootstrap ESTIMATE and the fused loop."""
from . import bootstrap, error_model, estimators, fused, keys, sampling
from .fused import (FusedResult, LaneParams, LaneState, fused_grouped,
                    fused_l2miss, fused_l2miss_batch, fused_l2miss_lanes,
                    fused_step, init_lane_state, lanes_result,
                    make_group_lane_params, make_lane_params)
from .sampling import GroupedData

__all__ = [
    "FusedResult", "GroupedData", "LaneParams", "LaneState", "bootstrap",
    "error_model", "estimators", "fused", "fused_grouped", "fused_l2miss",
    "fused_l2miss_batch", "fused_l2miss_lanes", "fused_step",
    "init_lane_state", "keys", "lanes_result", "make_group_lane_params",
    "make_lane_params", "sampling",
]
