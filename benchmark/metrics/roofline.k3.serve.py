"""K3 (``ops/decode_attention.py``, the int8-cache decode attention) in the
traced slice: the least time of the bytes its launches needed (every
slot's query and output, and the int8 K and V with their scales at the
live positions of the tokens the slice served) at the card's memory rate,
over its summed device time, in percent."""

import flops


def read(ctx):
    tl, s = ctx.get("timeline"), ctx.get("serve")
    if tl is None or not s:
        return None
    seconds, n = tl.kernel_seconds(r"decode_attention_kernel<")
    if n == 0 or seconds <= 0:
        return None
    c = ctx["c"]
    keys = s["k3_keys_slice"]
    need = flops.k3_bytes(c, s["slots"], 0) * n + flops.k3_bytes(c, 0, keys)
    ops = 4 * c["num_attention_heads"] * c["head_dim"] * keys
    return 100.0 * flops.bound_s(ops, need) / seconds
