from .query import Query, Request

__all__ = ["Query", "Request"]
