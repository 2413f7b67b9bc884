def read(s: dict):
    """Percent of the card's SMs that hold a K3 cluster at once, over the
    window's cluster launches: the port's K3 counters, resident CTAs over
    SM slots (None where the program has no such counters or launched no
    cluster)."""
    w = s["window_counters"]
    slots = w.get("k3_sm_slots")
    return 100.0 * w["k3_resident_ctas"] / slots if slots else None
