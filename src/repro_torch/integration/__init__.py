from .miss_eval import MissEvaluator
from .miss_mixture import mixture_statistics
from .miss_router import estimate_router_load

__all__ = ["MissEvaluator", "estimate_router_load", "mixture_statistics"]
