"""The step-overhead probe's plain version (svtrek_tpu_torch.ops.step_probe,
the CPU route of kernel K4) against the Pallas kernel of
tools/pallas_step_overhead.py run in interpret mode, exactly.

The tool's kernel is local to its main(), so its body is restated here as
it stands there (the `k` of `run`, tools/pallas_step_overhead.py:41-63),
without the TPU compiler parameters."""
from __future__ import annotations

import functools

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtrek_tpu_torch.ops import step_probe as sp


def pallas_probe(ptr: np.ndarray, rows_per: int) -> np.ndarray:
    N, B, WP = ptr.shape

    @functools.partial(jax.jit, static_argnames=("rows_per",))
    def run(ptr, rows_per=1):
        def k(in_ref, o_ref):
            gi = pl.program_id(0)

            @pl.when(gi == 0)
            def _():
                o_ref[:, :] = jnp.zeros_like(o_ref)

            acc = jnp.zeros((B, 1), jnp.int32)
            for r in range(rows_per):
                acc = acc + jnp.sum(in_ref[r, :, :].astype(jnp.int32),
                                    axis=1, keepdims=True)
            o_ref[:, 0:1] = o_ref[:, 0:1] + acc

        return pl.pallas_call(
            k, grid=(N // rows_per,),
            in_specs=[pl.BlockSpec((rows_per, B, WP),
                                   lambda gi: (gi, 0, 0))],
            out_specs=pl.BlockSpec((B, 128), lambda gi: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((B, 128), jnp.int32),
            interpret=True,
        )(ptr)

    return np.asarray(run(ptr, rows_per=rows_per))


# The tool's seed-0 input in [0, 3) at a small shape, and signed int8 over
# the whole range at a ragged one.
SHAPES = {"tool_input": ((16, 8, 128), 3), "signed_ragged": ((24, 5, 40), None)}


@pytest.mark.parametrize("rows_per", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_pallas(shape, rows_per):
    (N, B, WP), hi = SHAPES[shape]
    rng = np.random.default_rng(0)
    ptr = (rng.integers(0, hi, (N, B, WP)) if hi
           else rng.integers(-128, 128, (N, B, WP))).astype(np.int8)
    want = pallas_probe(ptr, rows_per)
    calls = sp.plain_calls["step_probe"]
    got = sp.step_probe(torch.from_numpy(ptr), rows_per).numpy()
    assert sp.plain_calls["step_probe"] == calls + 1
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert not got[:, 1:].any() and got[:, 0].any()


def test_rows_per_must_divide_n():
    with pytest.raises(ValueError, match="must divide"):
        sp.step_probe(torch.zeros((10, 2, 16), dtype=torch.int8), 4)
