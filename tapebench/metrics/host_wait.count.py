"""Host waits on the card per capture: the program's host_waits counter
over the telemetry phase's captures."""

from tapebench import telemetry_phase


def read(ctx):
    tel = telemetry_phase.of(ctx)
    if tel is None or not tel.captures:
        return None
    return sum(c["waits"] for c in tel.captures) / len(tel.captures)
