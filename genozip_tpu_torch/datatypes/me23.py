"""23andMe datatype plugin (reference parity: src/me23.c); counterpart of
genozip_tpu/datatypes/me23.py.
Records: rsid <tab> chromosome <tab> position <tab> genotype."""

from . import register
from .tabular import TabularDT


@register
class Me23DT(TabularDT):
    NAME = "me23"
    FIELDS = [("ID", "tok"), ("CHROM", "dict"), ("POS", "num_delta"),
              ("GT", "dict")]
    COMMENT_PREFIXES = (b"#",)
