"""The control, the float32 reference computed in float8 put in the
program's place, comes out as not correct at the tests' sizes against
their limits (``smoke_limits``); the chip's readings at the cells'
sizes are in PERF.md.  Also the reference's float8 rounding itself."""
import pytest
import torch

from benchtest import CELLS, ctx
from bench import calibrate
from bench.lib import spec
from bench.reference import common as C


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_number(cell):
    lim = spec.limits(cell, smoke=True)
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        got = calibrate.control_readings(ctx(cell, seed), 8,
                                         seconds=0.3)["control_fp8"]
        over = [k for k in lim if got[k] > lim[k]]
        assert over, (seed, got, lim)


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.3, 0.0])
    y = C.operand(x, "fp8")
    assert torch.equal(y[:3], torch.tensor([1.0, 1.0, 1.125]))
    assert float(y[3]) == 448.0 and float(y[5]) == 0.0
    assert abs(float(y[4]) + 3.3) / 3.3 < 2 ** -4
    g = torch.ones(4, requires_grad=True)
    up = torch.tensor([1.0, 1.1, 1.2, 1.3])
    (C.operand(g, "fp8") * up).sum().backward()
    rel = (g.grad - up).abs() / up
    assert float(rel.max()) <= 2 ** -3 and float(rel.max()) > 0
