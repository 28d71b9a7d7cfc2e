"""Block data parallelism over ranks (torch.distributed), port of
``lzs_tpu.parallel``."""

from .dist import (DistributedCodec, make_block_mesh, encode_sharded,
                   decode_sharded, initialize_distributed)

__all__ = ["DistributedCodec", "make_block_mesh", "encode_sharded",
           "decode_sharded", "initialize_distributed"]
