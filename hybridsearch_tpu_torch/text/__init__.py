"""Tokenization and preprocessing (pure Python and numpy)."""
