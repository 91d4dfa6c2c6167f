"""states_host_ms_per_call.updates: host ms a call inside the port's span
``pmc.lattice.states`` (the torus states compared to +1 and copied, pageable,
to the host, after the sweeps were waited for), over the traced calls. None
where the program records no such span."""

from portbench import spans


def read(view):
    return spans.ms_per_call(view, "pmc.lattice.states")
