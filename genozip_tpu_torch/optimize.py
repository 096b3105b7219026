"""--optimize: lossy transforms applied to the input before seg (reference
src/sam_modify.c optimize_phred_quality_string + flags.c flags_set_optimize).
Counterpart of genozip_tpu/optimize.py: the same tables.

The QUAL binning is the Illumina RTA 8-level scheme extended with 5-wide
bins above Phred 44 (the reference's table): Phred 0/1/2 unchanged, 3-9
-> 6, 10-19 -> 15, 20-24 -> 22, 25-29 -> 27, 30-34 -> 33, 35-39 -> 37,
then 5-wide bins centered at 42,47,...,87 up to Phred 89, 90-92 -> 91,
and 93 (PacBio max) unchanged. Applied to the whole VB with one LUT pass;
the archive digest covers the MODIFIED data (the round-trip reproduces
the optimized file, not the original — same contract as the reference).
"""

import numpy as np


def _build_phred_lut() -> np.ndarray:
    """ASCII-space LUT ('!'-based Phred+33); non-Phred bytes unchanged."""
    lut = np.arange(256, dtype=np.uint8)
    bins = {0: 0, 1: 1, 2: 2, 93: 93}
    for p in range(3, 10):
        bins[p] = 6
    for p in range(10, 20):
        bins[p] = 15
    for p in range(20, 25):
        bins[p] = 22
    for p in range(25, 30):
        bins[p] = 27
    for p in range(30, 35):
        bins[p] = 33
    for p in range(35, 40):
        bins[p] = 37
    for lo in range(40, 90, 5):           # 5-wide bins centered at lo+2
        for p in range(lo, lo + 5):
            bins[p] = lo + 2
    for p in range(90, 93):
        bins[p] = 91
    for p, b in bins.items():
        lut[p + 33] = b + 33
    return lut


PHRED_LUT = _build_phred_lut()

# raw-Phred space (BAM: qual bytes are Phred without +33; 0xFF = missing)
PHRED_LUT_RAW = np.arange(256, dtype=np.uint8)
PHRED_LUT_RAW[:94] = PHRED_LUT[33:127] - 33


def bin_qual_ascii(arr: np.ndarray) -> np.ndarray:
    """Bin an ASCII-Phred byte array (in place semantics: returns mapped)."""
    return PHRED_LUT[arr]


def bin_qual_raw(arr: np.ndarray) -> np.ndarray:
    """Bin raw-Phred bytes (BAM layout; 0xFF missing stays 0xFF)."""
    return PHRED_LUT_RAW[arr]
