"""Numpy scalar reference implementations (bit-exact oracles for the device kernels)."""
