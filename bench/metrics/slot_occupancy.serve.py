"""Batching: the mean, over the engine steps inside the window, of the
live lanes (requests admitted and not finished) as a share of the
engine's slots."""
LAYER = "serve/engine.py ServeEngine"
SOURCE = "program_counter"
UNIT = "%"
BETTER = "higher"
MOVES = "tokens_per_s"


def read(rec):
    serve = rec.get("serve")
    if not serve or not serve["steps"]:
        return None
    lanes = sum(s[2] for s in serve["steps"])
    return 100.0 * lanes / (len(serve["steps"]) * serve["batch_slots"])
