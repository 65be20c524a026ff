"""The caption step's share of the card's float32 peak, in %: the model's
operations a batch (satbench/counts/flops.py: VGG19's 16 convs, the keys,
and 51 beam steps of the decoder, top-k not counted) times the window's
batches a second, over the peak (satbench/counts/peaks.py)."""


def read(trace):
    if "flops_per_batch" not in trace:
        return None
    return (100.0 * trace["flops_per_batch"] * trace["batches_per_s"]
            / trace["peaks"]["f32_s"])
