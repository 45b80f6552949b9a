"""The card's mean power over the window: its energy counter's
difference between the window's open and close over the seconds
between them."""
LAYER = "H100 power"
SOURCE = "device_trace"
UNIT = "W"
BETTER = "lower"
MOVES = "joules_per_token"


def read(rec):
    if rec.get("energy_window_s", 0) <= 0:
        return None
    return rec["energy_j"] / rec["energy_window_s"]
