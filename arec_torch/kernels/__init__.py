"""Port of `arec.kernels`."""
