"""samples_host_ms_per_call.pt: host ms a call inside the port's span
``pmc.tempering.samples`` (the samples' stack after the accepted swaps were
read, then their compare and pageable copy to the host), over the traced
calls. None where the program records no such span."""

from portbench import spans


def read(view):
    return spans.ms_per_call(view, "pmc.tempering.samples")
