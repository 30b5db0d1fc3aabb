from ..aqp.query import Request
from .aqp_service import AQPResponse, AQPService
from .batching import ContinuousBatcher
from .lane_pool import GroupPoolResponse, LanePool, PoolResponse
from .planner import Planner, PoolPlan, Route
from .session import AQPSession, SessionResponse, SessionTicket
from .slo import (AdmissionController, CostModel, DegradePlan, FairQueue,
                  eps_for_budget)
from .warm_cache import CachedAnswer, WarmCache, WarmEntry

# ``Request`` here is the AQP serving request (aqp/query.py: Query + SLO
# envelope); the LM token-batching request lives at
# ``repro_torch.serve.batching.Request``.
__all__ = [
    "AQPResponse", "AQPService", "AQPSession", "AdmissionController",
    "CachedAnswer", "ContinuousBatcher", "CostModel", "DegradePlan",
    "FairQueue", "GroupPoolResponse", "LanePool", "Planner", "PoolPlan",
    "PoolResponse", "Request", "Route", "SessionResponse", "SessionTicket",
    "WarmCache", "WarmEntry", "eps_for_budget",
]
