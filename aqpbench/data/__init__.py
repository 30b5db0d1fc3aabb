"""Tables the benchmark makes from its seed."""
