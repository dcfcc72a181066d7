from .hll import HLL, ExactCounter, ReadCounts

__all__ = ["HLL", "ExactCounter", "ReadCounts"]
