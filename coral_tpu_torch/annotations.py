"""Built-in genome annotations.

GRCh38 centromere (acen band) boundaries, from the public UCSC cytoband
table.  The reference ships the same facts as a bed file
(``src/annotations/GRCh38_centromere.bed``) and parses it on every seed run
(``src/cnv_seed.py:30-41``); here the data is a compile-time dict.

Each entry maps chromosome -> (centromere_start, centromere_end), i.e. the
start of the p-side acen band and the end of the q-side acen band.
"""
from __future__ import annotations

from .constants import CHR_SIZES

GRCH38_CENTROMERES = {
    "chr1": (121700000, 125100000),
    "chr2": (91800000, 96000000),
    "chr3": (87800000, 94000000),
    "chr4": (48200000, 51800000),
    "chr5": (46100000, 51400000),
    "chr6": (58500000, 62600000),
    "chr7": (58100000, 62100000),
    "chr8": (43200000, 47200000),
    "chr9": (42200000, 45500000),
    "chr10": (38000000, 41600000),
    "chr11": (51000000, 55800000),
    "chr12": (33200000, 37800000),
    "chr13": (16500000, 18900000),
    "chr14": (16100000, 18200000),
    "chr15": (17500000, 20500000),
    "chr16": (35300000, 38400000),
    "chr17": (22700000, 27400000),
    "chr18": (15400000, 21500000),
    "chr19": (24200000, 28100000),
    "chr20": (25700000, 30400000),
    "chr21": (10900000, 13000000),
    "chr22": (13700000, 17400000),
    "chrX": (58100000, 63800000),
    "chrY": (10300000, 10600000),
}


def chr_arms(centromeres=None):
    """Chromosome-arm table used by seed mode.

    Returns {chrom: {"cen": (cen_start, cen_end),
                     "arm_sizes": (p_arm_len, q_arm_len)}}
    mirroring the fields the reference accumulates at
    ``src/cnv_seed.py:36-41`` (p arm length = cen_start; q arm length =
    chr_size - cen_end).
    """
    centromeres = centromeres or GRCH38_CENTROMERES
    out = {}
    for chrom, (cs, ce) in centromeres.items():
        out[chrom] = {
            "cen": (cs, ce),
            "arm_sizes": (cs, CHR_SIZES[chrom] - ce),
        }
    return out
