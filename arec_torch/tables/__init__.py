"""Port of `arec.tables`."""
