"""rav1d_jax: an AV1 decoder whose dense pass runs on an accelerator (JAX/XLA).

From-scratch implementation with the capabilities of dav1d/rav1d; see
DESIGN.md for architecture and SURVEY.md for the behavioral reference map.
"""

__version__ = "0.1.0"

from .decoder import Decoder, Settings, EAgain, DecodeError  # noqa: F401
