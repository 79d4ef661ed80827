"""Port of `arec.losses`."""
