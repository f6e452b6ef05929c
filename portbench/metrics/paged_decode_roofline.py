"""paged_decode_roofline: the least seconds of the traced decode steps'
paged attention (each live slot's K and V up to its position read once,
the table entries, q and the output, every layer; from the request
timeline's live requests and the prompt lengths sent) over the device
seconds of the paged decode kernel K4 in the trace."""

from portbench.readings import of, roofline_pct


def read(rec):
    if not of(rec, "serve"):
        return None
    return roofline_pct(rec, "paged_bound_s", ("decode_paged",))
