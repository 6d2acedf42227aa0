"""The port's aligned block gather (iridium_tpu_torch/ops/block_gather.py)
against the Pallas prototype of tools/exp_pallas_gather.py, run in
interpret mode on the CPU at small shapes, and the port's sweep tool at
its small shape.

The prototype's kernel body and scalar-prefetch grid spec
(exp_pallas_gather.py:55-80) are rebuilt here with `interpret=True`:
the tool's `run_one` fixes a 38M-sample stream and has no interpret
switch. Both sides are pure copies, so they must agree bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from iridium_tpu_torch.ops import block_gather as bg  # noqa: E402
from iridium_tpu_torch.tools import exp_block_gather  # noqa: E402

TILE = 640
MT = 64
B = 3


def pallas_block_gather(sre, sim, st, R, nt):
    """exp_pallas_gather.py:55-80 at (Mt, TILE) planes, interpret mode."""
    def kernel(st_ref, re_ref, im_ref, ore_ref, oim_ref):
        ore_ref[0] = re_ref[...]
        oim_ref[0] = im_ref[...]

    n = st.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(n, nt // R),
        in_specs=[
            pl.BlockSpec((R, TILE), lambda b, t, st: (st[b] + t, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((R, TILE), lambda b, t, st: (st[b] + t, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=[
            pl.BlockSpec((1, R, TILE), lambda b, t, st: (b, t, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, R, TILE), lambda b, t, st: (b, t, 0),
                         memory_space=pltpu.VMEM),
        ],
    )
    gather = pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((n, nt, TILE), jnp.float32),
                   jax.ShapeDtypeStruct((n, nt, TILE), jnp.float32)],
        interpret=True)
    o_re, o_im = gather(jnp.asarray(st), jnp.asarray(sre), jnp.asarray(sim))
    return np.asarray(o_re), np.asarray(o_im)


@pytest.mark.parametrize("R,nt", [(1, 8), (1, 16), (8, 8), (8, 16)])
def test_plain_equals_pallas_interpret(R, nt):
    rng = np.random.default_rng(100 * R + nt)
    sre = rng.standard_normal((MT, TILE)).astype(np.float32)
    sim = rng.standard_normal((MT, TILE)).astype(np.float32)
    # block starts in units of R rows, the last window ending on the
    # planes' last row
    st = rng.integers(0, (MT - nt) // R + 1, B).astype(np.int32)
    st[-1] = (MT - nt) // R
    want = pallas_block_gather(sre, sim, st, R, nt)
    got = bg.block_gather(torch.from_numpy(sre), torch.from_numpy(sim),
                          torch.from_numpy(st), R, nt)
    for g, w in zip(got, want):
        assert g.shape == (B, nt, TILE)
        np.testing.assert_array_equal(g.numpy(), w)


def test_rows_outside_the_planes_read_zero():
    sre = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    o_re, o_im = bg.block_gather(sre, -sre, torch.tensor([-1, 1],
                                                         dtype=torch.int32),
                                 2, 4)
    assert torch.equal(o_re[0, :2], torch.zeros(2, 8))
    assert torch.equal(o_re[0, 2:], sre[:2])
    assert torch.equal(o_re[1], sre[[2, 3, 0, 0]] * torch.tensor(
        [1.0, 1.0, 0.0, 0.0])[:, None])
    assert torch.equal(o_im, -o_re)


def test_tool_small_on_cpu(capsys):
    assert exp_block_gather.main(["--device", "cpu", "--small"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    assert [line.split(":")[0] for line in lines[1:]] == \
        ["R= 64", "R=128", "R=256"]
    for R in (64, 128, 256):
        sh = exp_block_gather.shapes(R, **exp_block_gather.SMALL)
        # the full-size sweep's window rounds up to 512 rows for every R
        assert exp_block_gather.shapes(
            R, **exp_block_gather.FULL)["nt"] == 512
        assert sh["nt"] % R == 0
        assert (sh["starts"].astype(np.int64) * R + sh["nt"]
                <= sh["Mt"]).all()
