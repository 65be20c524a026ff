"""The train step's share of the card's float32 peak, in %: the decoder's
forward and backward operations a step (satbench/counts/flops.py, remat's
second forward not counted) times the window's steps a second, over the
peak (satbench/counts/peaks.py)."""


def read(trace):
    if "flops_per_step" not in trace:
        return None
    return (100.0 * trace["flops_per_step"] * trace["steps_per_s"]
            / trace["peaks"]["f32_s"])
