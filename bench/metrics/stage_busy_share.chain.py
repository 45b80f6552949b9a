"""The executor: the stage replicas' busy time (the runtime's own
``busy_s``, wall time around each stage call, which waits for its
stream) over the replicas times the window."""
LAYER = "pipeline/runtime.py StreamingPipelineRuntime"
SOURCE = "program_span"
UNIT = "%"
BETTER = "higher"
MOVES = "tokens_per_s"


def read(rec):
    chain = rec.get("chain")
    if not chain or rec["window_s"] <= 0:
        return None
    return 100.0 * chain["busy_s"] / (chain["replicas"] * rec["window_s"])
