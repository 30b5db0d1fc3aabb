from ..aqp.query import Request
from .aqp_service import AQPResponse, AQPService
from .lane_pool import GroupPoolResponse, LanePool, PoolResponse
from .planner import Planner, PoolPlan, Route
from .session import AQPSession, SessionResponse, SessionTicket

# ``Request`` here is the AQP serving request (aqp/query.py: Query + SLO
# envelope); the LM token-batching request lives at
# ``repro_torch.serve.batching.Request``.
__all__ = ["AQPResponse", "AQPService", "AQPSession", "GroupPoolResponse",
           "LanePool", "Planner", "PoolPlan", "PoolResponse", "Request",
           "Route", "SessionResponse", "SessionTicket"]
