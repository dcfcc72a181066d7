"""Minimizer-range database partitioning (the out-of-core chunk planner's
cut; the multi-card mesh of the JAX package is a later slice)."""
