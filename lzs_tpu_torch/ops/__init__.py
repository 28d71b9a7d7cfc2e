"""The container codec path of lzs_tpu_torch (see the package docstring)."""

from .encode import encode_block, make_encoder
from .decode import decode_block, make_decoder

__all__ = ["encode_block", "make_encoder", "decode_block", "make_decoder"]
