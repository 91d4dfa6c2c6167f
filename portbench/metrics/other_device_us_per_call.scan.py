"""other_device_us_per_call.scan: ``other_device_us_per_call.updates`` in the
beta-scan cells, which report ``spin_updates_per_ns.scan``."""

from portbench.core import load_module

read = load_module("metrics", "other_device_us_per_call.updates").read
