"""Core MISS library of the port: estimators, error model, sampling, the
bootstrap ESTIMATE, the host-loop L2Miss with its metric extensions, and
the fused loop."""
from . import (bootstrap, error_model, estimators, extensions, fused, keys,
               sampling)
from .estimators import Estimator, evaluate
from .extensions import (metric_value, order_bound, run_diffmiss, run_lpmiss,
                         run_maxmiss, run_normalmiss, run_ordermiss)
from .framework import MissFailure, MissTrace, run_miss
from .fused import (FusedResult, LaneParams, LaneState, fused_grouped,
                    fused_l2miss, fused_l2miss_batch, fused_l2miss_lanes,
                    fused_step, init_lane_state, lanes_result,
                    make_group_lane_params, make_lane_params)
from .l2miss import MissConfig, exact_answer, run_l2miss
from .sampling import GroupedData

__all__ = [
    "Estimator", "FusedResult", "GroupedData", "LaneParams", "LaneState",
    "MissConfig", "MissFailure", "MissTrace", "bootstrap", "error_model",
    "estimators", "evaluate", "exact_answer", "extensions", "fused",
    "fused_grouped", "fused_l2miss", "fused_l2miss_batch",
    "fused_l2miss_lanes", "fused_step", "init_lane_state", "keys",
    "lanes_result", "make_group_lane_params", "make_lane_params",
    "metric_value", "order_bound", "run_diffmiss", "run_l2miss",
    "run_lpmiss", "run_maxmiss", "run_miss", "run_normalmiss",
    "run_ordermiss", "sampling",
]
