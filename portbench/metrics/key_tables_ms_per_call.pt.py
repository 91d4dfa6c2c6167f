"""key_tables_ms_per_call.pt: host ms a call inside the port's span
``pmc.tempering.key_tables`` (the per-sweep seeds and the swap uniforms made
on the host before the first sweep, and their copy to the card), over the
traced calls. None where the program records no such span."""

from portbench import spans


def read(view):
    return spans.ms_per_call(view, "pmc.tempering.key_tables")
