from .lane_pool import GroupPoolResponse, LanePool, PoolResponse
from .planner import Planner, PoolPlan, Route
from .session import AQPSession, SessionResponse, SessionTicket

__all__ = ["AQPSession", "GroupPoolResponse", "LanePool", "Planner",
           "PoolPlan", "PoolResponse", "Route", "SessionResponse",
           "SessionTicket"]
