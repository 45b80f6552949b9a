"""The whole chain's share of the card's bf16 peak: the model FLOPs of
the frames delivered in the window (``work.frame_flops``) over the peak
times the window, its fill and drain included."""
from bench import work

LAYER = "pipeline/stages.py model_stage_builder"
SOURCE = "host_clock"
UNIT = "%"
BETTER = "higher"
MOVES = "tokens_per_s"


def read(rec):
    chain, peaks = rec.get("chain"), rec.get("peaks")
    if not chain or not peaks:
        return None
    flops = chain["frames"] * work.frame_flops(rec["dims"],
                                               chain["tokens_per_frame"])
    return 100.0 * flops / (peaks["bf16_flops"] * rec["window_s"])
