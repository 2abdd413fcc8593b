"""The host's waits on the card (the program's wait.* spans: every read
of a card value and every blocking upload on the path), summed per
capture, median over the telemetry phase's captures, ms."""

from tapebench import telemetry_phase


def read(ctx):
    return telemetry_phase.median_ms(telemetry_phase.of(ctx), "wait_ns")
