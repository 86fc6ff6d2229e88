"""Tracing, counters and device selection."""
