# Copied from bzip2_tpu/constants.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Format constants of the .bz2 bitstream.

These mirror the on-wire format implemented by the reference
(``bzlib_private.h:130-157`` and ``compress.c:841-880``); the
values are mandated by the bzip2 file format, not by the reference's
implementation choices.
"""

# Stream header: 'B' 'Z' 'h' <level digit>.
HDR_B = 0x42
HDR_Z = 0x5A
HDR_h = 0x68
HDR_0 = 0x30

# 48-bit block / end-of-stream delimiters (compress.c:849-850, 874-875).
BLOCK_MAGIC = 0x314159265359
EOS_MAGIC = 0x177245385090

# Alphabet: nInUse symbols + RUNA/RUNB + EOB, at most 256 + 2.
MAX_ALPHA_SIZE = 258
RUNA = 0
RUNB = 1

# Huffman coding limits (bzlib_private.h:139-143).
LIMIT_CODE_LEN = 17   # encoder never emits codes longer than this (1.0.3+)
MAX_DECODE_LEN = 20   # decoder must accept pre-1.0.3 streams up to 20
MAX_CODE_LEN = MAX_DECODE_LEN + 3

# Group coding (bzlib_private.h:148-152).
N_GROUPS = 6
G_SIZE = 50
N_ITERS = 4
MAX_SELECTORS = 2 + (900000 // G_SIZE)  # 18002

# Cost constants used to seed the table-refinement iterations
# (compress.c:233-234).
LESSER_ICOST = 0
GREATER_ICOST = 15

# Block sizing: level L in 1..9 gives a post-RLE1 block budget of
# 100000*L - 19 bytes (bzlib.c:190); the RLE1 state machine may overshoot
# this by up to 9 bytes (flush of a pending run writes <= 5 bytes and the
# per-byte capacity check allows a 4-byte overshoot first).
BLOCK_UNIT = 100_000
BLOCK_OVERSHOOT = 9


def nblock_max(level: int) -> int:
    if not 1 <= level <= 9:
        raise ValueError(f"block size level must be in 1..9, got {level}")
    return BLOCK_UNIT * level - 19


# Error codes, mirroring bzlib.h:33-46 so library users can map behaviors
# one-to-one.
BZ_OK = 0
BZ_RUN_OK = 1
BZ_FLUSH_OK = 2
BZ_FINISH_OK = 3
BZ_STREAM_END = 4
BZ_SEQUENCE_ERROR = -1
BZ_PARAM_ERROR = -2
BZ_MEM_ERROR = -3
BZ_DATA_ERROR = -4
BZ_DATA_ERROR_MAGIC = -5
BZ_IO_ERROR = -6
BZ_UNEXPECTED_EOF = -7
BZ_OUTBUFF_FULL = -8
BZ_CONFIG_ERROR = -9

# Stream actions (bzlib.h:29-31).
BZ_RUN = 0
BZ_FLUSH = 1
BZ_FINISH = 2
