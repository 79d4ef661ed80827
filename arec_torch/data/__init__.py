"""Port of `arec.data`."""
