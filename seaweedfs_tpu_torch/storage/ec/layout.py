"""EC striping layout: how a volume .dat maps onto 14 shard files.

Semantics match the reference exactly (weed/storage/erasure_coding/
ec_locate.go, ec_encoder.go:17-23, encodeDatFile loop at :198-235) so shard
files interoperate:

- The .dat is consumed row-major. While more than one large row
  (10 x 1GB) remains, a large row is cut into 10 large blocks; the rest is
  cut into rows of 10 small (1MB) blocks, the final row zero-padded.
- Shard j's file = its large blocks in row order, then its small blocks.
- Parity shards 10..13 hold the RS parity of each row, same block sizes.

This is the system's "sequence sharding": a needle read touches only the
block(s) its byte range lands in, while encode streams sequentially.
"""

from __future__ import annotations

from dataclasses import dataclass

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS
# the widest shard set any codec writes (MSR's 18 files fit): the store's
# boot scan for shard files walks this many extensions
MAX_TOTAL_SHARDS = 32
LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1GB
SMALL_BLOCK_SIZE = 1024 * 1024  # 1MB


def to_ext(shard_id: int) -> str:
    return f".ec{shard_id:02d}"


@dataclass(frozen=True)
class Interval:
    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows: int
    # stripe width: k of the volume's codec (RS default; LRC shares the
    # same 10-wide geometry, MSR volumes stripe 9-wide)
    data_shards: int = DATA_SHARDS

    def to_shard_id_and_offset(self, large_block: int = LARGE_BLOCK_SIZE,
                               small_block: int = SMALL_BLOCK_SIZE) -> tuple[int, int]:
        """(shard_id, offset inside that shard's file)."""
        off = self.inner_block_offset
        row = self.block_index // self.data_shards
        if self.is_large_block:
            off += row * large_block
        else:
            off += self.large_block_rows * large_block + row * small_block
        return self.block_index % self.data_shards, off


def n_large_rows(dat_size: int, large_block: int = LARGE_BLOCK_SIZE,
                 small_block: int = SMALL_BLOCK_SIZE,
                 data_shards: int = DATA_SHARDS) -> int:
    """Number of 10-wide large-block rows for a volume of dat_size bytes.

    Exactly matches the encode loop's strict `remaining > 10*large`
    condition: rows are cut while MORE than one large row remains.

    Deliberate deviation: the reference derives this as
    `(datSize + 10*small) // (10*large)` (ec_locate.go:19-20), which
    disagrees with its own encode loop whenever the trailing small-row
    region is larger than 10*(large-small) bytes — reads in that window
    would misroute. We stay loop-consistent for every size instead; for
    sizes outside that window the two formulas agree."""
    del small_block  # kept in the signature for call-site symmetry
    row = large_block * data_shards
    if dat_size <= row:
        return 0
    return (dat_size - 1) // row


def n_small_rows(dat_size: int, large_block: int = LARGE_BLOCK_SIZE,
                 small_block: int = SMALL_BLOCK_SIZE,
                 data_shards: int = DATA_SHARDS) -> int:
    remaining = dat_size - \
        n_large_rows(dat_size, large_block, small_block, data_shards) \
        * large_block * data_shards
    return max(0, -(-remaining // (small_block * data_shards)))


def shard_file_size(dat_size: int, large_block: int = LARGE_BLOCK_SIZE,
                    small_block: int = SMALL_BLOCK_SIZE,
                    data_shards: int = DATA_SHARDS) -> int:
    """Size of each .ecXX file for a volume of dat_size bytes."""
    return n_large_rows(dat_size, large_block, small_block, data_shards) \
        * large_block + \
        n_small_rows(dat_size, large_block, small_block, data_shards) \
        * small_block


def locate_offset(large_block: int, small_block: int, dat_size: int,
                  offset: int,
                  data_shards: int = DATA_SHARDS) -> tuple[int, bool, int]:
    """-> (block_index, is_large_block, inner_block_offset)."""
    large_row = large_block * data_shards
    rows = n_large_rows(dat_size, large_block, small_block, data_shards)
    if offset < rows * large_row:
        return int(offset // large_block), True, int(offset % large_block)
    offset -= rows * large_row
    return int(offset // small_block), False, int(offset % small_block)


def locate_data(large_block: int, small_block: int, dat_size: int,
                offset: int, size: int,
                data_shards: int = DATA_SHARDS) -> list[Interval]:
    """Map a logical .dat byte range to the shard-block intervals covering it."""
    block_index, is_large, inner = locate_offset(
        large_block, small_block, dat_size, offset, data_shards)
    rows = n_large_rows(dat_size, large_block, small_block, data_shards)
    out: list[Interval] = []
    while size > 0:
        remaining = (large_block if is_large else small_block) - inner
        step = min(size, remaining)
        out.append(Interval(block_index, inner, step, is_large, rows,
                            data_shards))
        size -= step
        if size <= 0:
            break
        block_index += 1
        if is_large and block_index == rows * data_shards:
            is_large = False
            block_index = 0
        inner = 0
    return out
