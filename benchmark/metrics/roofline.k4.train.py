"""K4 (``ops/flash_attention.py``: forward, dQ, dK/dV at D 128) in the
traced step: the summed least times of its launches at the card's peaks
(``flops.k4_bounds``: causal same-sample pairs, live positions) over their
summed device time, in percent."""

KERNELS = {"fwd": r"attention_sm90_kernel<128, ?4>", "dq": r"flash_dq_sm90_kernel<", "dkv": r"flash_dkv_sm90_kernel<"}


def read(ctx):
    tl, tr = ctx.get("timeline"), ctx.get("train")
    if tl is None or not tr:
        return None
    bound = spent = 0.0
    for part, pattern in KERNELS.items():
        seconds, n = tl.kernel_seconds(pattern)
        bound += n * tr["k4_bounds"][part]
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
