"""states_host_ms_per_call.scan: ``states_host_ms_per_call.updates`` in the
beta-scan cells, which report ``spin_updates_per_ns.scan``."""

from portbench.core import load_module

read = load_module("metrics", "states_host_ms_per_call.updates").read
