"""K1 / K2 (``csrc/ntt.cu``) against their bound in the traced window: the
sum of each call's least time (``frozen.call_bound`` of its shape, credited
on replays through the frozen ``ShapeRecorder``) over the device time of
the kernels named ``ntt_*``."""

from hhe_bench import frozen


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.device_ms(lambda name: frozen.kernel_family(name) == "ntt")
    if ms <= 0 or run.ntt_bound_ms <= 0:
        return None
    return 100.0 * run.ntt_bound_ms / ms
