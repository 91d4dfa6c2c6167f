"""The work each kernel's function needs, counted from the algorithm's rule,
and the card's peaks: the yardstick of the roofline metrics.

Peaks of one NVIDIA H100 SXM5 (the data sheet's rates, at its full power
limit of 700 W; a card set lower runs slower, never faster):

- HBM3 at 3.35 TB/s;
- instruction issue: 132 SMs, each with four warp schedulers that issue one
  warp instruction (32 lanes) a clock, at the 1.98 GHz boost clock (the
  clock at which the data sheet's 67 TFLOP/s f32 is 132 x 128 lanes x 2
  operations of an FMA): 132 x 4 x 32 x 1.98e9 = 33.45 T lane-operations a
  second. Every operation, integer or float, on any pipe, takes an issue
  slot, so no kernel computes faster than its operations over this rate.

The least time of a function is the larger of its bytes over the bandwidth
and its operations over the issue rate. Operations are counted from the
rule, after every fusion the instruction set allows (a three-input logic
operation, a multiply-add, a right shift as the high half of a multiply),
so that no implementation can issue fewer; bytes count each input read once
and each output written once.

- The lane hash's draw (``lanehash.draw31``): ``a = seed + pos P1 + c G1``
  and ``b = pos P2 + c G2`` (one multiply-add each), three multiplies, five
  shifts and five logic operations (the xor with ``b`` folded into the
  third round's three-input xor; the last shift by one folded into the
  comparison): ``HASH_OPS`` = 15.
- A square-torus site update: its draw and the draw's comparison with the
  threshold (``SQ2D_OPS_PER_UPDATE`` = 16); the neighbour sum, the table's
  index and the flip act on bytes and are left out, so the count is a lower
  one.
- A ladder spin's site phase (``LADDER_SITE_OPS``): its draw; the uniform
  (convert, multiply-add, clamp); the logit (``1 - u``, two logs of
  ``LOG_OPS`` = 2 each, the hardware's base-2 logarithm and its scale, and
  the difference); the field (four products and three sums of the
  neighbours' couplings: four multiply-adds); the time neighbours' sum
  (an add and a convert); dE (``+ h``, ``dt *``, ``kt *``, the difference,
  ``-2 s *``: five); the comparison and the flip.
- A ladder slice's cluster phase (``LADDER_CLUSTER_OPS``): its draw; the
  uniform (three); the alignment test, the test against ``p_bond``; the
  field (four) and the slice's dE (three); the run sum's addition and the
  flip; a head adds its draw, uniform, log and test (``LADDER_HEAD_OPS``).
  A head follows each bond that is not frozen; a bond is frozen when its
  two slices align and its draw falls below ``p_bond``.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "SMS", "CLOCK_HZ", "ISSUE_OPS_PER_S", "HASH_OPS", "LOG_OPS", "SQ2D_OPS_PER_UPDATE",
           "LADDER_SITE_OPS", "LADDER_CLUSTER_OPS", "LADDER_HEAD_OPS", "least_s", "sq2d_need", "ladder_need"]

HBM_BYTES_PER_S = 3.35e12
SMS = 132
CLOCK_HZ = 1.98e9
ISSUE_OPS_PER_S = SMS * 4 * 32 * CLOCK_HZ

HASH_OPS = 15
LOG_OPS = 2
SQ2D_OPS_PER_UPDATE = HASH_OPS + 1
LADDER_SITE_OPS = HASH_OPS + 3 + (1 + 2 * LOG_OPS + 1) + 4 + 2 + 5 + 2
LADDER_CLUSTER_OPS = HASH_OPS + 3 + 2 + 4 + 3 + 2
LADDER_HEAD_OPS = HASH_OPS + 3 + LOG_OPS + 1


def least_s(nbytes: float, ops: float) -> float:
    """The least seconds of ``nbytes`` moved and ``ops`` operations issued."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ISSUE_OPS_PER_S)


def sq2d_need(R: int, L: int, sweeps: int, calls: int):
    """``(bytes, operations)`` of ``calls`` calls of ``sweeps`` sweeps on
    ``R`` replicas of an ``L`` x ``L`` torus: each int8 spin read and written
    once a call, the draws' seeds read once, and ``SQ2D_OPS_PER_UPDATE`` an
    update."""
    return calls * (2 * R * L * L + 4 * R), calls * R * L * L * sweeps * SQ2D_OPS_PER_UPDATE


def ladder_need(R: int, nvars: int, L: int, sweeps: int, heads: float):
    """``(bytes, operations)`` of ``sweeps`` sweeps of a ladder of ``R``
    rungs of ``nvars`` sites and ``L`` slices on a torus, with ``heads``
    cluster heads a sweep: the int8 state read once and written once a sweep
    (the sweep is the function; a kernel that reads it again a phase pays
    that itself), the rungs' couplings to two neighbours (f32) and four
    parameters read once; the operations of
    ``LADDER_SITE_OPS`` a spin, ``LADDER_CLUSTER_OPS`` a slice and
    ``LADDER_HEAD_OPS`` a head."""
    spins = R * nvars * L
    nbytes = 2 * spins + 4 * R * 2 * nvars + 16 * R
    ops = spins * (LADDER_SITE_OPS + LADDER_CLUSTER_OPS) + heads * LADDER_HEAD_OPS
    return sweeps * nbytes, sweeps * ops
