"""Device-side database lookup: the hash tables (hash_lookup) and the
binary search over the sorted planes (xla_lookup)."""
