from .registry import ARCHS, NOT_PORTED, get_config

__all__ = ["ARCHS", "NOT_PORTED", "get_config"]
