"""``mamba_scan``'s rounding-mode check (``kernels/mamba_scan/ops.py::
rounding_errs``), on the CPU.

In the rounding mode a kernel writes y = bf16(h.C) + D*x.  Its f32 sum h.C
and the plain version's run in other orders, so the check allows f32
slack at the sum's own scale, sum_s |h_s C_s| from an f64 scan, and then
at most one bf16 step of h.C (``ROUND_STEPS``) on at most 1 % of elements
(``ROUND_SHARE``).  A "kernel" here is the plain scan with its exponential
rounded from f64 and h.C summed in reverse order, or the Hopper kernel's
arithmetic emulated (fused state updates, per-lane partial sums, then a
shuffle tree across the lanes of a channel); inputs are made with numpy at
jamba-tiny's mamba shape (di 128, d_state 8, dt_rank 4) and at d_state
16."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro_torch.kernels.mamba_scan import ops as M  # noqa: E402

F32 = torch.float32
# the kernel's lanes a channel, as csrc/mamba_scan.cu fixes them
KERNEL_LANES = int(re.search(
    r"constexpr int kLanes = (\d+);",
    (Path(M.__file__).resolve().parents[2] / "csrc" / "mamba_scan.cu")
    .read_text()).group(1))


def _inputs(seed, B=2, T=45, di=128, ds=8, dtr=4, state=False):
    """chip_smoke.py's draws for mamba_scan, from numpy: B and C strided
    slices of one projection, A = -(1 .. ds), D = 1."""
    rng = np.random.RandomState(seed)

    def bf16(a):
        return torch.tensor(a, dtype=F32).to(torch.bfloat16)

    x = bf16(rng.randn(B, T, di))
    dt = bf16(np.log1p(np.exp(rng.randn(B, T, di) - 3)))
    dbc = bf16(rng.randn(B, T, dtr + 2 * ds))
    A = -torch.arange(1, ds + 1, dtype=F32).expand(di, ds).contiguous()
    h0 = (torch.tensor(rng.randn(B, di, ds) * 0.5, dtype=F32) if state
          else None)
    return [x, dt, dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:], A,
            torch.ones(di), h0]


def _scan_in_another_order(x, dt, Bc, Cc, A, D, h0=None):
    """The rounding mode as a kernel might compute it: the f32 scan with
    exp(dt*A) rounded from f64 and h.C summed from the last state lane to
    the first."""
    B, T, di = x.shape
    h = torch.zeros(B, di, A.shape[1]) if h0 is None else h0.clone()
    dtf, Bf, Cf = dt.float(), Bc.float(), Cc.float()
    dbx = dtf * x.float()
    ys = []
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None].double() * A.double()[None])
        h = dA.float() * h + dbx[:, t, :, None] * Bf[:, t, None, :]
        hc = torch.zeros(B, di)
        for s in reversed(range(A.shape[1])):
            hc = hc + h[..., s] * Cf[:, t, None, s]
        ys.append(hc.to(torch.bfloat16).float())
    return torch.stack(ys, 1) + x.float() * D.float()


def _steps_at_hc(y, ref, x, D):
    """The count before the repair: f32 slack at |y| and |D*x|, which reads
    one f32 rounding of a nearly cancelling h.C as many bf16 steps."""
    xD = x.float() * D.float()
    d = (y - ref).abs()
    slack = 8 * torch.finfo(F32).eps * (ref.abs() + xD.abs())
    _, e = torch.frexp((ref - xD).abs() + d)
    return float(((d - slack).clamp_min(0)
                  / torch.ldexp(torch.ones_like(d), e - 8)).max())


def _near_cancelling(seed=0, b=0, c=0, ds=8):
    """Inputs whose last step's h.C nearly cancels for (row b, channel c):
    x there is 0 (no D*x to hide it), and the last two lanes of C_t are the
    bf16 pair, near the exact solution, that leave the smallest residual."""
    args = _inputs(seed, ds=ds)
    x, dt, Bc, Cc, A = args[:5]
    T = x.shape[1]
    x[b, T - 1, c] = 0
    f64 = torch.float64
    h = torch.zeros(A.shape[1], dtype=f64)
    for t in range(T):
        h = (torch.exp(dt[b, t, c].to(f64) * A[c].to(f64)) * h
             + dt[b, t, c].to(f64) * x[b, t, c].to(f64) * Bc[b, t].to(f64))
    C = Cc[b, T - 1].to(f64)
    rest = float((h[:-2] * C[:-2]).sum())
    bits = C[-2:].to(F32).to(torch.bfloat16).view(torch.int16)
    best = None
    for d6 in range(-200, 201):
        c6 = float((bits[0] + d6).view(torch.bfloat16))
        c7 = torch.tensor(-(rest + float(h[-2]) * c6) / float(h[-1]))
        for d7 in (-1, 0, 1):
            c7n = float((c7.to(torch.bfloat16).view(torch.int16) + d7)
                        .view(torch.bfloat16))
            res = abs(rest + float(h[-2]) * c6 + float(h[-1]) * c7n)
            if best is None or res < best[0]:
                best = (res, c6, c7n)
    Cc[b, T - 1, -2], Cc[b, T - 1, -1] = best[1], best[2]
    return args, best[0] / float((h * Cc[b, T - 1].to(f64)).abs().sum())


@pytest.mark.parametrize("state", [False, True])
def test_rounding_errs_plain_against_plain_reads_zero(state):
    args = _inputs(0, state=state)
    ref, _ = M.mamba_scan_plain(*args, round_y=True)
    assert M.rounding_errs(ref, ref, *args) == (0.0, 0.0)


def test_rounding_errs_catches_an_unrounded_output():
    """A kernel that ignored the flag: its y is within half a bf16 step of
    the rounded one on every element (so under the step limit) and differs
    on nearly all of them (far over the share limit)."""
    args = _inputs(0)
    ref, _ = M.mamba_scan_plain(*args, round_y=True)
    y, _ = M.mamba_scan_plain(*args, round_y=False)
    steps, share = M.rounding_errs(y, ref, *args)
    assert steps <= 0.5 and share > 0.9, (steps, share)
    assert share > M.ROUND_SHARE


def test_rounding_errs_catches_an_output_steps_off():
    """An h.C off by 2**-6 of itself, about two bf16 steps on most
    elements: over both limits."""
    args = _inputs(1)
    ref, _ = M.mamba_scan_plain(*args, round_y=True)
    xD = args[0].float() * args[5]
    steps, share = M.rounding_errs((ref - xD) * (1 + 2 ** -6) + xD, ref,
                                   *args)
    assert steps > M.ROUND_STEPS and share > M.ROUND_SHARE, (steps, share)


def test_rounding_errs_passes_a_near_cancelling_sum():
    """The blind spot of the old count: where h.C nearly cancels (here to
    a few f32 epsilons of sum_s |h_s C_s|), one f32 rounding moves
    bf16(h.C) by several of its small steps.  Counted at |h.C| that read
    more than one step; counted past the slack at the sum's scale it
    reads within the limits."""
    args, residual = _near_cancelling()
    assert residual < 1e-6
    ref, _ = M.mamba_scan_plain(*args, round_y=True)
    y = _scan_in_another_order(*args)
    assert _steps_at_hc(y, ref, args[0], args[5]) > 1.0001
    steps, share = M.rounding_errs(y, ref, *args)
    assert steps <= M.ROUND_STEPS and share <= M.ROUND_SHARE, (steps, share)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), state=st.booleans())
def test_rounding_errs_passes_another_summation_order(seed, state):
    args = _inputs(seed, state=state)
    ref, _ = M.mamba_scan_plain(*args, round_y=True)
    steps, share = M.rounding_errs(_scan_in_another_order(*args), ref,
                                   *args)
    assert steps <= M.ROUND_STEPS and share <= M.ROUND_SHARE, (steps, share)


def _fma(a, b, c):
    """f32 a*b + c rounded once (the product of two f32 values is exact in
    f64; the sum's double rounding is within the emulation's purpose)."""
    return (a.double() * b.double() + c.double()).float()


def _scan_in_lane_tree_order(x, dt, Bc, Cc, A, D, h0=None, *, lanes):
    """The rounding mode in ``csrc/mamba_scan.cu``'s arithmetic: exp(dt*A)
    as exp2(dt * (A*log2(e))) in f32; the state update h = fma(dt*x, B,
    exp2(..)*h), the product rounded first (dt*x*B is exact in f32);
    ``lanes`` lanes a channel, lane g holding states g*ds/lanes ..
    (g+1)*ds/lanes - 1; its partial h.C a chain of fused multiply-adds in
    state order, then log2(lanes) steps of s += shfl_xor(s, o), o =
    lanes/2 .. 1, in f32; y = fma(x, D, bf16(s))."""
    B, T, di = x.shape
    ds = A.shape[1]
    spl = ds // lanes
    h = torch.zeros(B, di, ds) if h0 is None else h0.clone()
    dtf, Bf, Cf = dt.float(), Bc.float(), Cc.float()
    dbx = dtf * x.float()
    a2 = A * torch.tensor(math.log2(math.e), dtype=F32)
    lane = torch.arange(lanes)
    ys = []
    for t in range(T):
        h = _fma(dbx[:, t, :, None], Bf[:, t, None, :],
                 torch.exp2(dtf[:, t, :, None] * a2[None]) * h)
        part = torch.zeros(B, di, lanes)
        for k in range(spl):
            s = lane * spl + k
            part = _fma(h[..., s], Cf[:, t, None, s], part)
        o = lanes // 2
        while o:
            part = part + part[..., lane ^ o]
            o //= 2
        ys.append(part[..., 0].to(torch.bfloat16).float())
    return _fma(x.float(), D.float(), torch.stack(ys, 1))


@pytest.mark.parametrize("ds", M.STATE_SIZES)
@pytest.mark.parametrize("seed", [0, 1])
def test_rounding_errs_passes_the_kernels_lane_tree_order(ds, seed):
    """The kernel's lanes a channel, at jamba-tiny's shape (and at d_state
    16), with and without a state in: within the unchanged limits."""
    args = _inputs(seed, ds=ds, state=bool(seed))
    ref, _ = M.mamba_scan_plain(*args, round_y=True)
    y = _scan_in_lane_tree_order(*args, lanes=KERNEL_LANES)
    steps, share = M.rounding_errs(y, ref, *args)
    assert steps <= M.ROUND_STEPS and share <= M.ROUND_SHARE, (steps, share)


@pytest.mark.parametrize("ds", M.STATE_SIZES)
def test_rounding_errs_passes_the_lane_tree_on_a_near_cancelling_sum(ds):
    """The constructed near-cancelling h.C (seed 0's construction at d_state
    8; at 16 seed 0's leaves 1.8e-6 of the scale, seed 1's 5e-8)."""
    args, residual = _near_cancelling(seed=0 if ds == 8 else 1, ds=ds)
    assert residual < 1e-6
    ref, _ = M.mamba_scan_plain(*args, round_y=True)
    y = _scan_in_lane_tree_order(*args, lanes=KERNEL_LANES)
    steps, share = M.rounding_errs(y, ref, *args)
    assert steps <= M.ROUND_STEPS and share <= M.ROUND_SHARE, (steps, share)
