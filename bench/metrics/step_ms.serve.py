"""The engine step: the mean host time of one ``ServeEngine.step`` call
inside the window (admission, the token feed, one replay of the captured
decode step, the copy of its tokens back and the bookkeeping), not the
time spent waiting for arrivals between steps."""
LAYER = "serve/graph.py CapturedStep"
SOURCE = "host_clock"
UNIT = "ms"
BETTER = "lower"
MOVES = "itl_p95_ms"


def read(rec):
    serve = rec.get("serve")
    if not serve or not serve["steps"]:
        return None
    return 1e3 * sum(s[1] - s[0] for s in serve["steps"]) \
        / len(serve["steps"])
