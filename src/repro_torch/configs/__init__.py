from .registry import (ARCHS, NOT_PORTED, SHAPES, get_config, get_shape,
                       list_archs)

__all__ = ["ARCHS", "NOT_PORTED", "SHAPES", "get_config", "get_shape",
           "list_archs"]
