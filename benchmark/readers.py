"""Readers that the per-layer metrics of several cells share: a metric's
file under ``metrics/`` takes one of these as its ``read``, so a metric of
a new cell is a file of one line."""


def idle_share(ctx):
    """The share of the traced slice's wall time in which no kernel, copy or
    memset ran on the card (the union of the device intervals of
    ``torch.profiler``'s trace), in percent."""
    tl = ctx.get("timeline")
    share = None if tl is None else tl.idle_share()
    return None if share is None else 100.0 * share


def engine_step_ms(ctx):
    """Host milliseconds per decode step of the engine: the wall of the
    public ``ServingEngine.step(num_steps)`` calls of the window before
    the traced slice (admissions included) over the decode steps they
    ran."""
    s = ctx.get("serve")
    if not s or not s["decode_steps"]:
        return None
    return 1e3 * s["call_wall"] / s["decode_steps"]
