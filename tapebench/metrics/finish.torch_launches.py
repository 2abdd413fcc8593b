"""Kernel launches the finishes make per capture: the host-side CUDA
runtime launch calls of the telemetry phase's profiled trace inside the
program's finish spans (nrzi_finish, pe_finish, gcr_finish), over its
captures. Nothing without a card."""

from tapebench import telemetry_phase


def read(ctx):
    tel = telemetry_phase.of(ctx)
    return None if tel is None else tel.finish_launches
