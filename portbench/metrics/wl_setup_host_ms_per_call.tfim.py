"""wl_setup_host_ms_per_call.tfim: host ms a call inside the port's span
``pmc.worldline.setup`` (the replicas' keys and random initial states, the
parameters, the lattice's detection, the state's copy to the card and its
expansion over the slices), over the traced calls. None where the program
records no such span."""

from portbench import spans


def read(view):
    return spans.ms_per_call(view, "pmc.worldline.setup")
