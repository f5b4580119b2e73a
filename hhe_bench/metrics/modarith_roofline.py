"""K3-K6 (``csrc/modarith.cu``) against their bound in the traced window:
the sum of each call's least time (``frozen.mont_bound`` for K3 / K4, the
distinct operand and output bytes by ``frozen.words_bytes`` for K5 / K6)
over the device time of the kernels of those families."""

from hhe_bench import frozen

FAMILIES = ("mont", "mod_elem", "mod_down")


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.device_ms(lambda name: frozen.kernel_family(name) in FAMILIES)
    if ms <= 0 or run.modarith_bound_ms <= 0:
        return None
    return 100.0 * run.modarith_bound_ms / ms
