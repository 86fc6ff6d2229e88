"""Device-resident dense and sparse indexes and the Indexer."""
