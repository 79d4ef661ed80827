"""Port of `arec.fusion`."""
