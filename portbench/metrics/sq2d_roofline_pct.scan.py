"""sq2d_roofline_pct.scan: ``sq2d_roofline_pct`` in the beta-scan cells, which
report ``spin_updates_per_ns.scan``."""

from portbench.core import load_module

read = load_module("metrics", "sq2d_roofline_pct").read
