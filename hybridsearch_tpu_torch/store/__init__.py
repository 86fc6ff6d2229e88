"""Host-side sqlite store."""
