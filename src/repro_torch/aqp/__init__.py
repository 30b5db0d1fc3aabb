from .query import Query, Request
from .engine import AQPEngine

__all__ = ["AQPEngine", "Query", "Request"]
