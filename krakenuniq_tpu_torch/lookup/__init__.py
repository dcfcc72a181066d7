"""Device-side database lookup (CHD hash table)."""
