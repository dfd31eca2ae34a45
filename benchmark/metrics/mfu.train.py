"""The align step's model operations (``flops.train_step_ops``: the
forward once, dx through the frozen decoder, dx and dW of the trained
modules; 2 of 8 experts a token in a MoE) over the wall of the window's
untraced steps, as a share of the card's peak for each product's
precision, in percent."""


def read(ctx):
    tr = ctx.get("train")
    if not tr or not tr["steps"]:
        return None
    return 100.0 * tr["step_ops"].seconds_at_peak() * tr["steps"] / tr["wall"]
