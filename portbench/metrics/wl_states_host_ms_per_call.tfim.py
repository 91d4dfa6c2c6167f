"""wl_states_host_ms_per_call.tfim: host ms a call inside the port's span
``pmc.worldline.states`` (slice 0 compared to +1 and copied, pageable, to the
host, after the energies' sums were copied, which waits for the sweeps), over
the traced calls. None where the program records no such span."""

from portbench import spans


def read(view):
    return spans.ms_per_call(view, "pmc.worldline.states")
