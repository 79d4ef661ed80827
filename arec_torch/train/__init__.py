"""Port of `arec.train`."""
