from .tree import Taxonomy
from .resolve import resolve_reads

__all__ = ["Taxonomy", "resolve_reads"]
