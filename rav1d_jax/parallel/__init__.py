"""Multi-device decode: the sharded residual stage (resid.py)."""
