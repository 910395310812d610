"""The share of the query-key pairs the Conformer's attention computes that involve
padding: one less the rows' own T'^2 (counter ``conformer.attn_pairs_own``) over rows
times the padded T'^2 (``conformer.attn_pairs``), summed over the traced steps."""
from benchmark.harness import program_trace


def read(record):
    return program_trace.pad_share("conformer.attn_pairs", "conformer.attn_pairs_own")
