"""The served model operations of the window's calls before the traced
slice (``flops.prefill_ops`` per admission, ``flops.decode_ops`` per
decoded token: live positions only, 2 of 8 experts a token in a MoE), over
the wall from the window's start to the end of those calls, as a share of
the card's peak for each product's precision, in percent."""


def read(ctx):
    s = ctx.get("serve")
    if not s or s["wall_before_slice"] <= 0:
        return None
    return 100.0 * s["ops_before_slice"].seconds_at_peak() / s["wall_before_slice"]
