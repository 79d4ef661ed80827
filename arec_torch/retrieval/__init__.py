"""Port of `arec.retrieval`."""
