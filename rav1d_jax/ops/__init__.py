"""DSP kernels (device dense plane): itx, ipred, mc, loopfilter, cdef, lr, filmgrain.

Each family has a numpy reference implementation in ops.ref (the
checkasm-style oracle) and a batched JAX implementation in ops.dev.
"""
