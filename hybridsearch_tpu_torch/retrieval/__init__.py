"""The hybrid Searcher and query memory."""
