"""pool_tail_pct: the share of the producer pool's worker-seconds spent
idle at a pass's end, in % (`pool_tail=` of run_audit's `[VERBOSE] stages`
line, the last chunk's end less each worker's last chunk's end, summed
over the workers; over `workers=` x the pass's seconds).  None where no
pass printed `pool_tail` (a program without it)."""


def read(run):
    timed = [p for p in run.passes if "pool_tail" in p.stats]
    capacity = sum(p.stats.get("workers", 0) * p.seconds for p in timed)
    if not capacity:
        return None
    return 100.0 * sum(p.stats["pool_tail"] for p in timed) / capacity
