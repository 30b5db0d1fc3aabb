from .lane_pool import LanePool, PoolResponse
from .planner import Planner, PoolPlan, Route
from .session import AQPSession, SessionResponse, SessionTicket

__all__ = ["AQPSession", "LanePool", "Planner", "PoolPlan", "PoolResponse",
           "Route", "SessionResponse", "SessionTicket"]
