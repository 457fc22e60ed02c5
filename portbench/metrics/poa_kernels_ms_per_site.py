"""poa_kernels_ms_per_site: device time of the star consensus's kernels
(K2 strip and wide, K3 traceback; csrc/poa.cu) a consensus site, in ms."""
from _common import total

KERNELS = ("poa_dp_ptr_strip_kernel", "poa_dp_ptr_wide_kernel",
           "poa_traceback_kernel")


def read(run):
    t = run.trace
    sites = total(run, "cons_sites")
    k = t.kernel_s(*KERNELS) if t is not None else None
    if not k or not sites:
        return None
    return k * 1000.0 / sites
