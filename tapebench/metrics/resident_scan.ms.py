"""The host activity scan of the resident tape (the program's
resident.scan span in _resident_tape: segment.host_activity for int16
samples), per capture, median over the telemetry phase's captures, ms."""

from tapebench import telemetry_phase


def read(ctx):
    return telemetry_phase.median_ms(telemetry_phase.of(ctx), "scan_ns")
