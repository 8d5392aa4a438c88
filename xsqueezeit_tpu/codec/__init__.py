"""Block codec: host and device block encoders/decoders, file drivers."""
from collections import Counter

#: Blocks per codec path in this process: "encode_device" / "encode_host"
#: (compressor.BlockEncodeDispatcher) and "decode_device" / "decode_host"
#: (decoder_jax.decode_block_records, Accessor) — how a run shows which
#: engine did the block work.
BLOCK_COUNTS: Counter = Counter()
