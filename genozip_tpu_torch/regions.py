"""Region specs (`cat -r/--regions`) and the random-access index.

Counterpart of genozip_tpu/regions.py (reference src/regions.c: parse -r
specs, drop the lines outside them; src/random_access.c: per-VB (chrom,
min POS, max POS) entries, stored in SEC_RANDOM_ACCESS, by which `cat`
skips whole VBs).
"""

import numpy as np

from .contexts import dedup_col
from .ref.refstore import chrom_canonical
from .utils import ragged


def parse_regions(spec: str):
    """Parse "chr21,chr22:100-200,chrX:500" -> list of (chrom, start, end).
    start/end are inclusive; None chrom matches any."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            chrom, rng = part.split(":", 1)
            if "-" in rng:
                a, b = rng.split("-", 1)
                start = int(a) if a else 0
                end = int(b) if b else 2**62
            else:
                start = end = int(rng)
        else:
            chrom, start, end = part, 0, 2**62
        out.append((chrom, start, end))
    return out


def _chrom_match(spec: str, name: str) -> bool:
    if spec == name or spec == "":
        return True
    return chrom_canonical(spec) == chrom_canonical(name)


def regions_overlap(regions, chrom: str, lo: int, hi: int) -> bool:
    for (c, s, e) in regions:
        if _chrom_match(c, chrom) and not (hi < s or lo > e):
            return True
    return False


def ra_entries(chrom_words, b250, pos_vals):
    """Per-VB random-access entries [(chrom, min_pos, max_pos)] from a chrom
    dict column (VB-local words), per-line word indices and per-line
    positions."""
    out = []
    if b250 is None or pos_vals is None or b250.shape[0] == 0:
        return out
    npos = min(b250.shape[0], pos_vals.shape[0])
    b = b250[:npos]
    p = pos_vals[:npos]
    for w in np.unique(b):
        m = b == w
        name = chrom_words.row(int(w)).decode("utf-8", "replace")
        out.append([name, int(p[m].min()), int(p[m].max())])
    return out


# per-datatype (chrom col, start col, end col) of text lines, tab-split
FILTER_COLUMNS = {
    "vcf": (0, 1, 1),
    "sam": (2, 3, 3),
    "gff": (0, 3, 4),
    "bed": (0, 1, 2),
    "me23": (1, 2, 2),
}


def filter_lines(buf: bytes, dt_name: str, regions) -> bytes:
    """Drop text lines outside the regions (comment/header lines kept)."""
    cols = FILTER_COLUMNS.get(dt_name)
    if cols is None:
        return buf
    data = np.frombuffer(buf, np.uint8)
    nl = np.nonzero(data == ord("\n"))[0]
    if data.shape[0] and (nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1):
        nl = np.concatenate([nl, [data.shape[0]]])
    starts = np.concatenate([[0], nl[:-1] + 1])
    lines = ragged.gather_ranges(data, starts, nl - starts)
    n = len(lines)
    keep = np.zeros(n, dtype=bool)
    first = np.zeros(n, dtype=np.uint8)
    ne = lines.lens > 0
    first[ne] = data[starts[ne]] if data.shape[0] else 0
    is_hdr = (first == ord("#")) | (first == ord("@"))
    keep |= is_hdr
    tabs = ragged.count_sep_per_row(lines, ord("\t"))
    maxc = max(cols) + 1
    cand = ~is_hdr & (tabs >= maxc - 1) & ne
    idx = np.nonzero(cand)[0]
    if idx.shape[0]:
        sub = ragged.take(lines, idx)
        fields, rest, good, bad = ragged.split_first_fields(sub, ord("\t"), maxc)
        ng = good.shape[0]
        svals, sok = ragged.atoi(fields[cols[1]])
        evals, eok = ragged.atoi(fields[cols[2]])
        km = np.zeros(ng, dtype=bool)
        # group rows by chrom string (few chroms)
        uw, inv = dedup_col(fields[cols[0]])
        for w in range(len(uw)):
            name = uw.row(w).decode("utf-8", "replace")
            rows = inv == w
            for (c, s, e) in regions:
                if _chrom_match(c, name):
                    km |= rows & sok & eok & (evals >= s) & (svals <= e)
        # map back: good-subset rows -> original line numbers
        keep[idx[good][km]] = True
    kept = np.nonzero(keep)[0]
    out = ragged.take(lines, kept)
    return ragged.interleave([out], sep_after=[b"\n"]).data.tobytes()
