from .synthetic import DISTRIBUTIONS, make_grouped
from .tpch import make_lineitem

__all__ = ["DISTRIBUTIONS", "make_grouped", "make_lineitem"]
