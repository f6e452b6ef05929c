"""tick_host_ms.serve: the host time of a scheduler tick outside the
engine's programs: the benchmark's spans around Scheduler.tick over the
window, less the scheduler's own serve.decode_ms, serve.mixed_ms and
serve.prefill_ms (a final prefill chunk reads its token back, so its
span holds device time), per tick."""

from portbench.readings import of


def read(rec):
    if not of(rec, "serve") or rec["ticks"] <= 0:
        return None
    inside = sum(s for s, _ in rec["hist_ms"].values())
    return (rec["tick_s"] * 1e3 - inside) / rec["ticks"]
