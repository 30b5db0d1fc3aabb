from .synthetic import (DISTRIBUTIONS, INCONSISTENT_DISTS, INCONSISTENT_FUNCS,
                        make_grouped, make_regression, make_single_group)
from .tpch import add_group_bias, make_lineitem

__all__ = ["DISTRIBUTIONS", "INCONSISTENT_DISTS", "INCONSISTENT_FUNCS",
           "add_group_bias", "make_grouped", "make_lineitem",
           "make_regression", "make_single_group"]
