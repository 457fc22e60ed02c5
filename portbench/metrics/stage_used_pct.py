"""stage_used_pct: the share of the producer pool's inflated bytes that
the walk of its staged fetches reads, in % (100 x `walked_mb` over
`inflated_mb` of run_audit's `[VERBOSE] stages` line: each record's
length, fixed fields, name and CIGAR, against every byte of the blocks
inflated; the rest, SEQ, QUAL and tags, comes back over PCIe unread).
Where the card inflates every staged block (`inflate_card_pct` 100),
`inflated_mb` is `card_inflated_mb`.  None where no pass printed
`walked_mb` (a program without it) or nothing was inflated."""
from _common import total
from _stages import printed


def read(run):
    inflated = total(run, "inflated_mb")
    if not printed(run, "walked_mb") or not inflated:
        return None
    return 100.0 * total(run, "walked_mb") / inflated
