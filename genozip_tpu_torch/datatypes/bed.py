"""BED datatype plugin (reference parity: src/bed.c); counterpart of
genozip_tpu/datatypes/bed.py."""

from . import register
from .tabular import TabularDT


@register
class BedDT(TabularDT):
    NAME = "bed"
    FIELDS = [("CHROM", "dict"), ("START", "num_delta"), ("END", "num_delta"),
              ("NAME", "tok"), ("SCORE", "tok"), ("STRAND", "dict"),
              ("TSTART", "num_delta"), ("TEND", "num_delta"), ("RGB", "dict"),
              ("BCOUNT", "num"), ("BSIZES", "tok1"), ("BSTARTS", "tok1")]
    COMMENT_PREFIXES = (b"#", b"b", b"t")  # browser/track/comment lines
