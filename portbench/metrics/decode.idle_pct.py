"""Share of the decode calls' time in which no operation ran on the card:
the card's busy time over trace_calls traced calls, against the host
clock's time of as many untraced calls (the profiler slows the host)."""


def read(t: dict):
    if t.get("kind") != "decode" or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["clock_s"])
