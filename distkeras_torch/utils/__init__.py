"""Host-side utilities of the port (metrics JSONL, device selection)."""
