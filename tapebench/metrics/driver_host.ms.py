"""The driver's Python per capture: the self time of the program's
capture span and of its driver.* spans (segments, the calibration, the
staged retry's stages, remainder rounds or the PE walk, block emission),
with no synchronize; median over the telemetry phase's captures, ms."""

from tapebench import telemetry_phase


def read(ctx):
    return telemetry_phase.median_ms(telemetry_phase.of(ctx), "driver_ns")
