def read(s: dict):
    """Percent of the window's words that failed the first stage and were
    escalated, from the campaign's own counters."""
    w = s["window_counters"]
    return 100.0 * w["escalations"] / w["words"] if w.get("words") else None
