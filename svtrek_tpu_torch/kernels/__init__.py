"""Hand-written CUDA kernels and their ctypes bindings.

The library is built from `csrc/` at the first launch (`build.build`) and
loaded once.  Each wrapper takes CUDA tensors only, checks them, allocates
its outputs with `torch.empty`, launches on the current stream and raises
if the launch fails.  `launch_counts` counts each wrapper's launches, so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes as ct

import torch

# Kernel launches per wrapper since the last reset_launch_counts().
launch_counts: dict[str, int] = {"consensus_pos": 0}

_LIB = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def load_library():
    """Build (if stale) and load the kernel library; raises on failure."""
    global _LIB
    if _LIB is None:
        from .build import build

        lib = ct.CDLL(build())
        ptr = ct.c_void_p
        lib.svtrek_consensus_pos.restype = ct.c_int
        lib.svtrek_consensus_pos.argtypes = [
            ptr, ptr, ptr, ct.c_int, ct.c_int, ct.c_int,
            ct.c_int, ct.c_int, ct.c_int, ptr, ptr, ptr,
        ]
        lib.svtrek_cuda_error_string.restype = ct.c_char_p
        lib.svtrek_cuda_error_string.argtypes = [ct.c_int]
        _LIB = lib
    return _LIB


def _check_i32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def consensus_pos_cuda(locs: torch.Tensor, n: torch.Tensor,
                       pos: torch.Tensor, *, min_count: int, interval: int,
                       range_: int, sweep_width: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1 (csrc/consensus.cu): the whole batched consensus_pos.

    locs [B, K] int32, rows sorted ascending with INT32_MAX padding;
    n [B] int32 valid counts (<= K); pos [B] int32.  Returns (refined [B]
    int32 with -1 = NA, overflow [B] bool), equal to
    `ops.consensus.consensus_pos_batch_reference`."""
    if locs.device.type != "cuda":
        raise ValueError(f"consensus_pos_cuda takes CUDA tensors, got "
                         f"{locs.device}")
    if locs.dim() != 2 or locs.shape[1] == 0:
        raise ValueError(f"locs must be [B, K] with K >= 1, got "
                         f"{tuple(locs.shape)}")
    if sweep_width < 1:
        raise ValueError(f"sweep_width must be >= 1, got {sweep_width}")
    B, K = locs.shape
    _check_i32("locs", locs, (B, K), locs.device)
    _check_i32("n", n, (B,), locs.device)
    _check_i32("pos", pos, (B,), locs.device)
    refined = torch.empty(B, dtype=torch.int32, device=locs.device)
    overflow = torch.empty(B, dtype=torch.bool, device=locs.device)
    if B == 0:
        return refined, overflow
    lib = load_library()
    with torch.cuda.device(locs.device):
        stream = torch.cuda.current_stream(locs.device).cuda_stream
        rc = lib.svtrek_consensus_pos(
            locs.data_ptr(), n.data_ptr(), pos.data_ptr(), B, K,
            min(sweep_width, K), min_count, interval, range_,
            refined.data_ptr(), overflow.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"consensus_pos kernel launch failed: "
            f"{lib.svtrek_cuda_error_string(rc).decode()} ({rc})")
    launch_counts["consensus_pos"] += 1
    return refined, overflow
