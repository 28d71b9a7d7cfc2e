"""Codec profiles — the framework's "model zoo".

Port of ``lzs_tpu.models``. An LZS framework has no neural models; the
analogue of a model family is a *codec profile*: a named (offset coder,
length coder) bundle. ``standard`` is the ANSI X3.241-1994 wire format
that the port's kernels and the reference C library implement; the
others exercise the generalized coder layer (python/lzs.py:171-641
capability).
"""

from .profiles import PROFILES, get_profile  # noqa: F401
