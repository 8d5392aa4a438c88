"""XSI container reader/writer.

File layout (v5, restated from /root/reference/include/xsi_factory.hpp:435-639
and interfaces.hpp:161-315):

    [256-byte header]
    [block 0] [pad to 4] [block 1] [pad to 4] ...
    [pad to 8]
    [block index: u64 absolute file offset per block]
    [sample names: NUL-terminated strings]
    (header rewritten with final offsets)

Each block is a top-level binary block:

    [dictionary: {KEY_GT_ENTRY: offset}] [GT block payload]

optionally wrapped (when the zstd flag is set) as

    [compressed_size: u64][original_size: u64][zstd frame]
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .constants import BlockDict
from .dictionary import read_dictionary, write_dictionary
from .header import XsiHeader


class ZstdLayer:
    """Frame codec of the --zstd block layer: the `zstandard` module when
    it is installed, else the native library's libzstd binding.  Raises
    ValueError (a one-line CLI error) when neither is available."""

    def __init__(self, level: int = 7):
        self.level = level
        try:
            import zstandard
        except ImportError:
            try:
                from ..interop.native import NativeZstd
                self._native = NativeZstd()
            except Exception as exc:
                raise ValueError(
                    "--zstd needs the zstandard module or a native library "
                    f"built with zstd ({exc})") from None
        else:
            self._native = None
            self._cctx = zstandard.ZstdCompressor(level=level)
            self._dctx = zstandard.ZstdDecompressor()

    def compress(self, blob: bytes) -> bytes:
        if self._native is not None:
            return self._native.compress(blob, self.level)
        return self._cctx.compress(blob)

    def decompress(self, frame, size: int) -> bytes:
        if self._native is not None:
            return self._native.decompress(frame, size)
        return self._dctx.decompress(frame, max_output_size=size)


def wrap_top_level_block(gt_payload: bytes) -> bytes:
    """Frame a GT block payload as a top-level binary block."""
    d = {BlockDict.KEY_GT_ENTRY: 0}
    dict_bytes = write_dictionary(d)
    d[BlockDict.KEY_GT_ENTRY] = len(dict_bytes)
    return write_dictionary(d) + gt_payload


class XsiWriter:
    """Streams blocks to an .xsi file; finalize() rewrites the header."""

    def __init__(self, path: str, header: XsiHeader, sample_list: list[str],
                 zstd_on: bool = False, zstd_level: int = 7):
        self.path = path
        self.header = header
        self.header.zstd = zstd_on
        self.sample_list = sample_list
        self.zstd_on = zstd_on
        self._zstd = ZstdLayer(zstd_level) if zstd_on else None
        self.f = open(path, "wb")
        self.f.write(header.pack())
        self.header.wahs_offset = self.f.tell()
        self.indices: list[int] = []

    def write_block(self, gt_payload: bytes) -> None:
        blob = wrap_top_level_block(gt_payload)
        self.indices.append(self.f.tell())
        if self.zstd_on:
            comp = self._zstd.compress(blob)
            self.f.write(len(comp).to_bytes(8, "little"))
            self.f.write(len(blob).to_bytes(8, "little"))
            self.f.write(comp)
        else:
            self.f.write(blob)
        pad = (-self.f.tell()) % 4
        if pad:
            self.f.write(b"\0" * pad)

    def finalize(self, num_variants: int, xcf_entries: int, max_ploidy: int) -> None:
        h = self.header
        pad = (-self.f.tell()) % 8
        if pad:
            self.f.write(b"\0" * pad)
        h.indices_offset = self.f.tell()
        self.f.write(np.asarray(self.indices, np.uint64).tobytes())
        h.samples_offset = self.f.tell()
        for s in self.sample_list:
            self.f.write(s.encode() + b"\0")
        h.num_variants = num_variants
        h.xcf_entries = xcf_entries
        h.ploidy = max_ploidy
        h.hap_samples = len(self.sample_list) * max_ploidy
        h.num_samples = len(self.sample_list)
        h.number_of_ssas = ((xcf_entries + h.ss_rate - 1) // h.ss_rate
                            if h.ss_rate else 0)
        end = self.f.tell()
        self.f.seek(0)
        self.f.write(h.pack())
        self.f.close()
        # per-section byte accounting (reference parity: the factory prints
        # section sizes during compression, xsi_factory.hpp:567-591)
        self.section_bytes = {
            "header": 256,
            "blocks": h.indices_offset - h.wahs_offset,
            "indices": h.samples_offset - h.indices_offset,
            "samples": end - h.samples_offset,
            "total": end,
        }


@dataclass
class XsiReader:
    """Random-access reader over an .xsi container."""

    path: str
    header: XsiHeader = field(init=False)
    samples: list[str] = field(init=False)
    indices: np.ndarray = field(init=False)

    def __post_init__(self):
        with open(self.path, "rb") as f:
            self.data = memoryview(f.read())
        self.header = XsiHeader.unpack(bytes(self.data[:256]))
        h = self.header
        if h.version not in (4, 5):
            raise ValueError(f"Unsupported XSI version {h.version}")
        idx_dtype = np.uint64 if h.version >= 5 else np.uint32
        n_blocks = max(h.number_of_ssas, 0)
        end = h.samples_offset
        self.indices = np.frombuffer(
            self.data[h.indices_offset:h.indices_offset
                      + n_blocks * np.dtype(idx_dtype).itemsize], idx_dtype)
        # Sample names: NUL-terminated strings from samples_offset to EOF.
        raw = bytes(self.data[h.samples_offset:])
        names = raw.split(b"\0")
        n_samples = (h.hap_samples // h.ploidy) if h.ploidy else 0
        self.samples = [n.decode() for n in names[:n_samples]]
        self._zstd = ZstdLayer() if h.zstd else None
        self._block_cache: tuple[int, bytes] | None = None

    @property
    def n_samples(self) -> int:
        return len(self.samples)

    @property
    def n_haps(self) -> int:
        return self.header.hap_samples

    @property
    def aet_dtype(self):
        return np.uint16 if self.header.aet_bytes == 2 else np.uint32

    def n_blocks(self) -> int:
        return len(self.indices)

    def block_bytes(self, block_id: int) -> bytes | memoryview:
        """The decompressed top-level block blob."""
        if self._block_cache is not None and self._block_cache[0] == block_id:
            return self._block_cache[1]
        off = int(self.indices[block_id])
        if self.header.zstd:
            szb = 8 if self.header.version >= 5 else 4
            comp_size = int.from_bytes(self.data[off:off + szb], "little")
            orig_size = int.from_bytes(self.data[off + szb:off + 2 * szb], "little")
            blob = self._zstd.decompress(
                self.data[off + 2 * szb:off + 2 * szb + comp_size],
                orig_size)
        else:
            nxt = (int(self.indices[block_id + 1])
                   if block_id + 1 < len(self.indices) else self.header.indices_offset)
            blob = self.data[off:nxt]
        self._block_cache = (block_id, blob)
        return blob

    def gt_block_payload(self, block_id: int) -> memoryview:
        blob = self.block_bytes(block_id)
        d, _ = read_dictionary(blob, 0)
        off = d[BlockDict.KEY_GT_ENTRY]
        return memoryview(blob)[off:]
