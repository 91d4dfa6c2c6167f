"""idle_key_tables_pct.pt: the share of the traced window in which the host
was inside the port's span ``pmc.tempering.key_tables`` and no kernel, copy or
set ran on the card, in %. None where the program records no such span."""

from portbench import spans


def read(view):
    us = spans.idle_us(view, "pmc.tempering.key_tables")
    if us is None or view.window_s <= 0:
        return None
    return 100.0 * us * 1e-6 / view.window_s
