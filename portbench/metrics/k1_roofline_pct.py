"""k1_roofline_pct: K1's (consensus_pos_kernel) share of its roofline.

The least time the work needs: every window's candidates read once as
int32 and its result written once as int32, over the card's 3.35 TB/s
(peaks.py); the counts come from the reference's walk of the generated
inputs (modes/audt.py's `candidates`), not from the program's padded batch.  Divided
by K1's device time in the trace."""
from peaks import HBM_BYTES_PER_S

KERNEL = "consensus_pos_kernel"


def read(run):
    t = run.trace
    k1 = t.kernel_s(KERNEL) if t is not None else None
    if not k1 or not run.work:
        return None
    need = 4 * (run.work["candidates"] + run.work["windows"])
    return 100.0 * need / HBM_BYTES_PER_S / k1
