"""The planner's period for the chain (``plan_pipeline`` on the card's
datasheet rates) over the period the runtime measured on its steady
frames: 1 where the plan's roofline model holds."""
LAYER = "pipeline/planner.py plan_pipeline"
SOURCE = "host_clock"
UNIT = "ratio"
BETTER = "higher"
MOVES = "tokens_per_s"


def read(rec):
    chain = rec.get("chain")
    if not chain or chain["period_s"] <= 0:
        return None
    return chain["plan_period_s"] / chain["period_s"]
