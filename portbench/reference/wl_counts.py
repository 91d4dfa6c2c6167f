"""The work a sweep of the worldline kernel's function needs, counted from
the rule of ``worldline.py`` as ``counts.py`` counts (its peaks, its lane
hash and its log): after every fusion the instruction set allows, so that
no implementation issues fewer; each input byte read once and each output
byte written once.

- A spin's site phase (``WL_SITE_OPS``): of the four site phases a sweep,
  one updates each spin: its draw (``HASH_OPS``) and the draw's comparison
  with the threshold. The neighbour sums, the table's index and the flip act
  on bytes and are left out, as ``counts.SQ2D_OPS_PER_UPDATE`` leaves them.
- A slice's cluster phase (``WL_SLICE_OPS``): of the two cluster phases a
  sweep, one walks each line: the bond's draw and its comparison with the
  bond threshold, the alignment test of the bond's two slices, and the run
  sum's addition of the slice's dE.
- A cluster head (``WL_HEAD_OPS``): its draw, the uniform ``(u31 + 0.5)
  2^-31`` (a convert, an add and a multiply, each rounded, so no fusion),
  the log (``LOG_OPS``) and the test against ``-dE``.
- Bytes: the int8 state read once and written once a sweep (the sweep is
  the function; a kernel that reads it again a phase pays that itself). The
  seeds, the tables and the three sums, a few hundred bytes, are left out.
"""

from __future__ import annotations

from .counts import HASH_OPS, LOG_OPS

__all__ = ["WL_SITE_OPS", "WL_SLICE_OPS", "WL_HEAD_OPS", "wl_need"]

WL_SITE_OPS = HASH_OPS + 1
WL_SLICE_OPS = HASH_OPS + 1 + 1 + 1
WL_HEAD_OPS = HASH_OPS + 3 + LOG_OPS + 1


def wl_need(R: int, nvars: int, L: int, sweeps: int, heads: float):
    """``(bytes, operations)`` of ``sweeps`` sweeps of ``R`` replicas of
    ``nvars`` sites and ``L`` slices with ``heads`` cluster heads a sweep."""
    spins = R * nvars * L
    return sweeps * 2 * spins, sweeps * (spins * (WL_SITE_OPS + WL_SLICE_OPS) + heads * WL_HEAD_OPS)
