"""Host-side utilities: bit-exact numpy primitives (`bits`) and synthetic
demo databases for benchmarks (`demo`)."""
