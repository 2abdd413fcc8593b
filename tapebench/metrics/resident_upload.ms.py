"""The resident tape's upload (the program's resident.upload span:
from_numpy, the pageable copy to the card and the transposing copy),
per capture, median over the telemetry phase's captures, ms."""

from tapebench import telemetry_phase


def read(ctx):
    return telemetry_phase.median_ms(telemetry_phase.of(ctx), "upload_ns")
