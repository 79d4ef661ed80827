"""Port of `arec.models`."""
