"""Data: the deterministic synthetic token stream and its prefetcher."""
