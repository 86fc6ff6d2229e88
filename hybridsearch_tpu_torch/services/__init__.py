"""Result caches: exact-key caches and the LSH semantic cache."""
