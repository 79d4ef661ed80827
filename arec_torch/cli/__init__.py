"""Port of `arec.cli`."""
