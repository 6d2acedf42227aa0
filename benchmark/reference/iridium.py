"""Iridium air-interface protocol constants.

Frozen copy of `iridium_tpu_torch/iridium.py` (the benchmark's yardstick: later
changes to the program do not move it).

Parity source: reference `iridium.h:15-53` (symbol rate, UW tables, frame
length bounds, default detector parameters). These are protocol facts, not
code: any Iridium receiver shares them.
"""

SYMBOLS_PER_SECOND = 25_000
UW_LENGTH = 12

SIMPLEX_FREQUENCY_MIN = 1_626_000_000

PREAMBLE_LENGTH_SHORT = 16
PREAMBLE_LENGTH_LONG = 64

MIN_FRAME_LENGTH_NORMAL = 131  # IBC frame
MAX_FRAME_LENGTH_NORMAL = 191

MIN_FRAME_LENGTH_SIMPLEX = 80  # Single page IRA
MAX_FRAME_LENGTH_SIMPLEX = 444

# Unique words (QPSK symbols, not bits) — reference iridium.h:30-31
UW_DL = (0, 2, 2, 2, 2, 0, 0, 0, 2, 0, 0, 2)
UW_UL = (2, 2, 0, 0, 0, 2, 0, 0, 2, 0, 2, 2)

DEFAULT_CENTER_FREQ = 1_622_000_000
DEFAULT_THRESHOLD_DB = 16.0
DEFAULT_BURST_WIDTH_HZ = 40_000
DEFAULT_SPS = 10
DEFAULT_HISTORY_SIZE = 512

BURST_POST_MS = 16  # ms of signal kept after a burst ends
MAX_BURST_MS = 90  # maximum burst duration

# Access codes: the 24 bits the UW symbols decode to after DQPSK
# (reference frame_decode.c:51-56)
ACCESS_DL = (0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1)
ACCESS_UL = (1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0)
