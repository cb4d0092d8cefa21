"""Share of the pair-HMM values the program checked that it recomputed in
float64 on the host (its escalation of suspect f32 values), %."""


def read(record):
    esc = record["escalations"]
    if not esc["checked"]:
        return None
    return 100.0 * esc["escalated"] / esc["checked"]
