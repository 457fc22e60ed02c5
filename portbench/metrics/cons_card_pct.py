"""cons_card_pct: the share of the consensus reader's inflated bytes that
the card inflated, in % (100 x `card_mb` over `inflated_mb` of run_audit's
`[VERBOSE] ins_consensus` line, read as `cons_card_mb` and
`cons_inflated_mb`: AuditStats.cons_card_bytes over
AuditStats.cons_inflated_bytes).  How often the SEQ fetch's staged batch
inflate engages; None where no pass printed `card_mb` there (a program
without it)."""
from _common import total
from _stages import printed


def read(run):
    inflated = total(run, "cons_inflated_mb")
    if not printed(run, "cons_card_mb") or not inflated:
        return None
    return 100.0 * (total(run, "cons_card_mb") / inflated)
